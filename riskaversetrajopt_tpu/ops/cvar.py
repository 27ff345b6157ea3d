"""Risk estimators: VaR / AVaR (CVaR) of sampled statistics.

The reference estimates AVaR by solving the Rockafellar-Uryasev LP as an OSQP
QP with M+1 variables and 2M rows per evaluation (car/driving.py:639-671,
drone/drone_risk.py:663-695, hopper/hopper.py:926-958) and VaR by a sort-order
statistic (drone/drone_main_plot.py:640-652). The QP's optimizer t* is exactly
the empirical alpha-VaR, so on the device both reduce to one sort — no solver. A
QP-backed path is kept for parity validation (tests cross-check the two).
"""

from __future__ import annotations

import jax.numpy as jnp


def var_sorted(Z, alpha):
    """Empirical VaR_alpha: smallest t with (1/M) sum 1{Z_i > t} <= alpha.

    Matches monte_carlo_var (drone_main_plot.py:640-652): the
    (floor(alpha*M)+1)-th largest sample."""
    M = Z.shape[0]
    Z_sorted = jnp.sort(Z)
    xth = jnp.floor(alpha * M).astype(jnp.int32)
    return Z_sorted[M - xth - 1]


def avar(Z, alpha):
    """Empirical AVaR_alpha (a.k.a. CVaR): t* + mean(max(Z - t*, 0)) / alpha
    with t* the empirical VaR — the closed-form optimum of the
    Rockafellar-Uryasev program the reference solves as a QP
    (car/driving.py:639-671)."""
    t = var_sorted(Z, alpha)
    return t + jnp.mean(jnp.maximum(Z - t, 0.0)) / alpha


class AVaRQPOps:
    """Matrix-free operator for the Rockafellar-Uryasev estimation QP

        min 1/(M alpha) sum y_i + t   s.t.  -y <= 0,  -y - t <= -Z

    over z = [y (M) | t], rows [(-I 0); (-I -1)] — never materializes the
    reference's dense (2M, M+1) matrix (car/driving.py:645-658), so the
    QP-backed path works at the reference's MC size M=10000
    (car/driving.py:621). The KKT matrix N = sigma I + A^T R A is
    diagonal-plus-arrow; the solve is a scalar Schur complement over t."""

    def __init__(self, M, dtype):
        self.M = M
        self.dtype = dtype

    def matvec_P(self, z):
        return jnp.zeros_like(z)

    def matvec_A(self, z):
        y, t = z[:-1], z[-1]
        return jnp.concatenate([-y, -y - t])

    def rmatvec_A(self, w):
        M = self.M
        w1, w2 = w[:M], w[M:]
        return jnp.concatenate([-w1 - w2, -jnp.sum(w2)[None]])

    def row_inf_norms(self, D):
        D_y, D_t = D[:-1], D[-1]
        return jnp.concatenate([D_y, jnp.maximum(D_y, D_t)])

    def col_inf_norms(self, E):
        M = self.M
        E1, E2 = E[:M], E[M:]
        return jnp.concatenate(
            [jnp.maximum(E1, E2), jnp.max(E2)[None]]
        )

    def col_inf_norms_P(self, D):
        return jnp.zeros_like(D)

    def factorize(self, rho_vec, sigma_vec, cost_scale=1.0):
        M = self.M
        r1, r2 = rho_vec[:M], rho_vec[M:]
        Dy = sigma_vec[:-1] + r1 + r2
        N_tt = sigma_vec[-1] + jnp.sum(r2)
        S_t = N_tt - jnp.sum(r2 * r2 / Dy)
        return (Dy, r2, S_t)

    def kkt_solve(self, factor, rhs, rho_vec, sigma_vec, cost_scale=1.0):
        Dy, r2, S_t = factor
        r_y, r_t = rhs[:-1], rhs[-1]
        t = (r_t - jnp.sum(r2 * r_y / Dy)) / S_t
        y = (r_y - r2 * t) / Dy
        return jnp.concatenate([y, t[None]])


def avar_qp(Z, alpha, cfg=None):
    """QP-backed AVaR estimator reproducing the reference formulation exactly
    (inf_t t + 1/(M alpha) sum y_i s.t. y >= 0, y >= Z - t), for parity
    validation against `avar`. IPM backend over the structured operator."""
    from riskaversetrajopt_tpu.ops.ipm import IPMConfig, solve_qp_ipm

    Z = jnp.asarray(Z)
    M = Z.shape[0]
    dtype = Z.dtype
    q = jnp.concatenate([jnp.full(M, 1.0 / (M * alpha), dtype), jnp.ones(1, dtype)])
    l = jnp.full(2 * M, -jnp.inf, dtype)
    u = jnp.concatenate([jnp.zeros(M, dtype), -Z])
    ops = AVaRQPOps(M, dtype)
    sol = solve_qp_ipm(ops, q, l, u, n_eq=0, cfg=cfg or IPMConfig(tol=1e-8))
    t_risk = sol.x[-1]
    return t_risk + jnp.mean(jnp.maximum(Z - t_risk, 0.0) / alpha)
