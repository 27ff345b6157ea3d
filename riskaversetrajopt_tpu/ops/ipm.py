"""Primal-dual interior-point QP solver (Mehrotra predictor-corrector).

Solves the OSQP-form problem
    minimize    (1/2) x^T P x + q^T x
    subject to  l <= A x <= u
where the FIRST n_eq rows are equalities (l_i == u_i) handled exactly via a
dense Schur complement on their multipliers, and the remaining rows get
logarithmic barriers on their finite sides.

Why IPM: ADMM takes O(10^3-10^4) cheap serial iterations on the
degenerate LP-like CVaR epigraph QPs (each iteration is a small latency-bound
matvec), while Mehrotra converges in O(10-30) heavy iterations whose dominant
costs — the batched Jacobian contraction inside factorize() and a small dense
Cholesky — are large dense matmul-shaped work. The same operator interface as
ops/admm.py is reused (factorize / kkt_solve with per-row weights), so the
structured sample-sharded SAA operators drive both backends. This solver is
also the foundation of the NLP solver replacing IPOPT for the hopper workload
(SURVEY.md section 2.2).

Newton reduction (rows split eq / ineq; W_l = Lambda_l S_l^-1 etc.):
    N dx + A_eq^T dy_eq = R,   N = P + sigma I + A_in^T (W_l + W_u) A_in
    A_eq dx = -r_eq
    => (A_eq N^-1 A_eq^T) dy_eq = A_eq N^-1 R + r_eq   (n_eq x n_eq dense)
with fraction-to-boundary steps and the standard Mehrotra centering
sigma = (mu_aff / mu)^3.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from riskaversetrajopt_tpu.ops.admm import (
    QPSolution,
    ScaledOps,
    _polish,
    ruiz_equilibrate,
)


class IPMConfig(NamedTuple):
    tol: float = 1e-8
    max_iter: int = 50
    tau: float = 0.995  # fraction-to-boundary
    sigma_reg: float = 1e-9  # primal regularization in N
    s_init: float = 1.0
    lam_init: float = 1.0
    # Optional active-set polish of the final iterate. The polish candidate is
    # only accepted when it improves both residuals; on the degenerate CVaR
    # epigraph QPs the active set is frequently non-unique and the candidate
    # is rejected, so this defaults off (the interior solution is already well
    # past reference accuracy).
    polish: bool = False
    polish_refine_iters: int = 3


def solve_qp_ipm(
    ops,
    q,
    l,
    u,
    n_eq: int,
    cfg: IPMConfig = IPMConfig(),
    scale: bool = True,
    ruiz_iters: int = 5,
) -> QPSolution:
    """Interior-point solve. `ops` follows the ops/admm.py operator interface.

    The first `n_eq` rows of (l, u) must satisfy l == u (static count so the
    equality Schur complement has a fixed shape under jit).

    With `scale` (default) the iteration runs on the Ruiz-equilibrated
    problem — essential in f32: the raw SAA QP mixes MULTIPLIER-scaled rows,
    1e-7-gated rows, and an O(M*alpha) CVaR coefficient, and the resulting
    Newton systems lose their small pivots in f32 as M grows (observed: at
    M=1000/f32 the unscaled solve stalls at merit ~1e-1 while the scaled one
    converges; at f64 both converge). The returned solution, residuals, and
    the `solved` flag are certified UNSCALED (OSQP termination semantics,
    osqp/src/auxil.c residual scales)."""
    if scale:
        scaling = ruiz_equilibrate(ops, q, l, u, iters=ruiz_iters)
        sops = ScaledOps(ops, scaling)
        qbar = scaling.c * scaling.D * q
        lbar = scaling.E * l
        ubar = scaling.E * u
        sol = _solve_qp_ipm_raw(sops, qbar, lbar, ubar, n_eq, cfg)
        x = scaling.D * sol.x
        y = scaling.E * sol.y / scaling.c
        Ax = ops.matvec_A(x)
        z = jnp.clip(Ax, l, u)
        # unscaled OSQP-style relative residual certification
        Px = ops.matvec_P(x)
        Aty = ops.rmatvec_A(y)
        prim = jnp.max(jnp.abs(Ax - z))
        dual = jnp.max(jnp.abs(Px + q + Aty))
        p_sc = jnp.maximum(jnp.max(jnp.abs(Ax)), 1.0)
        d_sc = jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Px)), jnp.max(jnp.abs(Aty))),
            jnp.maximum(jnp.max(jnp.abs(q)), 1.0),
        )
        return QPSolution(
            x=x,
            y=y,
            z=z,
            iters=sol.iters,
            prim_res=prim,
            dual_res=dual,
            solved=(prim <= cfg.tol * p_sc) & (dual <= cfg.tol * d_sc),
        )
    return _solve_qp_ipm_raw(ops, q, l, u, n_eq, cfg)


def _solve_qp_ipm_raw(
    ops,
    q,
    l,
    u,
    n_eq: int,
    cfg: IPMConfig = IPMConfig(),
) -> QPSolution:
    dtype = q.dtype
    n = q.shape[0]
    m = l.shape[0]
    mi = m - n_eq  # inequality rows

    b_eq = l[:n_eq]
    l_in = l[n_eq:]
    u_in = u[n_eq:]
    has_l = jnp.isfinite(l_in)
    has_u = jnp.isfinite(u_in)
    n_sides = jnp.maximum(jnp.sum(has_l) + jnp.sum(has_u), 1).astype(dtype)
    sigma_vec = jnp.full(n, cfg.sigma_reg, dtype)

    # one-hot eq row selectors for building A_eq^T columns via rmatvec
    eq_rows = jnp.zeros((n_eq, m), dtype).at[jnp.arange(n_eq), jnp.arange(n_eq)].set(
        1.0
    )
    A_eq_T = jax.vmap(ops.rmatvec_A)(eq_rows)  # (n_eq, n): row i = A_eq[i, :]

    def matvec_A_in(x):
        return ops.matvec_A(x)[n_eq:]

    def rmatvec_with(w_eq, w_in):
        return ops.rmatvec_A(jnp.concatenate([w_eq, w_in]))

    q_norm = jnp.max(jnp.abs(q)) + 1.0
    # bound scale for relative primal termination
    b_norm = (
        jnp.maximum(
            jnp.max(jnp.where(jnp.isfinite(l), jnp.abs(l), 0.0)),
            jnp.max(jnp.where(jnp.isfinite(u), jnp.abs(u), 0.0)),
        )
        + 1.0
    )
    # barrier-weight safeguard, dtype-aware: f32 KKT factorizations lose the
    # small-pivot information once weights pass ~1e6
    _W_MAX = 1e13 if dtype == jnp.float64 else 3e6

    class _S(NamedTuple):
        x: jnp.ndarray
        y_eq: jnp.ndarray
        s_l: jnp.ndarray
        s_u: jnp.ndarray
        lam_l: jnp.ndarray
        lam_u: jnp.ndarray
        it: jnp.ndarray
        prim_res: jnp.ndarray
        dual_res: jnp.ndarray
        gap: jnp.ndarray
        done: jnp.ndarray
        # best-so-far iterate (returned on divergence/stall — the QP solutions
        # here can be dual-degenerate and late barrier iterations may diverge)
        best_merit: jnp.ndarray
        best_x: jnp.ndarray
        best_y_eq: jnp.ndarray
        best_lam_l: jnp.ndarray
        best_lam_u: jnp.ndarray
        best_s_l: jnp.ndarray
        best_s_u: jnp.ndarray
        best_prim: jnp.ndarray
        best_dual: jnp.ndarray
        best_gap: jnp.ndarray

    x0 = jnp.zeros(n, dtype)
    Ax0 = ops.matvec_A(x0)[n_eq:]
    s_l0 = jnp.where(has_l, jnp.maximum(Ax0 - l_in, cfg.s_init), 1.0)
    s_u0 = jnp.where(has_u, jnp.maximum(u_in - Ax0, cfg.s_init), 1.0)
    lam0 = jnp.full(mi, cfg.lam_init, dtype)
    init = _S(
        x=x0,
        y_eq=jnp.zeros(n_eq, dtype),
        s_l=s_l0,
        s_u=s_u0,
        lam_l=jnp.where(has_l, lam0, 0.0),
        lam_u=jnp.where(has_u, lam0, 0.0),
        it=jnp.zeros((), jnp.int32),
        prim_res=jnp.asarray(jnp.inf, dtype),
        dual_res=jnp.asarray(jnp.inf, dtype),
        gap=jnp.asarray(jnp.inf, dtype),
        done=jnp.asarray(False),
        best_merit=jnp.asarray(jnp.inf, dtype),
        best_x=x0,
        best_y_eq=jnp.zeros(n_eq, dtype),
        best_lam_l=jnp.where(has_l, lam0, 0.0),
        best_lam_u=jnp.where(has_u, lam0, 0.0),
        best_s_l=s_l0,
        best_s_u=s_u0,
        best_prim=jnp.asarray(jnp.inf, dtype),
        best_dual=jnp.asarray(jnp.inf, dtype),
        best_gap=jnp.asarray(jnp.inf, dtype),
    )

    def residuals(s: _S):
        Ax = ops.matvec_A(s.x)
        Ax_in = Ax[n_eq:]
        r_eq = Ax[:n_eq] - b_eq
        r_l = jnp.where(has_l, Ax_in - s.s_l - l_in, 0.0)
        r_u = jnp.where(has_u, u_in - Ax_in - s.s_u, 0.0)
        y_in = s.lam_u - s.lam_l
        Px = ops.matvec_P(s.x)
        Aty = rmatvec_with(s.y_eq, y_in)
        r_d = Px + q + Aty
        mu = (jnp.dot(s.s_l, s.lam_l) + jnp.dot(s.s_u, s.lam_u)) / n_sides
        prim = jnp.maximum(
            jnp.max(jnp.abs(r_eq), initial=0.0),
            jnp.maximum(jnp.max(jnp.abs(r_l)), jnp.max(jnp.abs(r_u))),
        )
        dual = jnp.max(jnp.abs(r_d))
        # OSQP-style relative scales: the duals of degenerate CVaR rows are
        # legitimately large, so stationarity must be judged relative to the
        # gradient magnitudes actually present.
        d_scale = jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Px)), jnp.max(jnp.abs(Aty))), q_norm
        )
        p_scale = jnp.maximum(jnp.max(jnp.abs(Ax)), b_norm)
        return r_eq, r_l, r_u, r_d, mu, prim, dual, p_scale, d_scale

    def cond(s: _S):
        return jnp.logical_not(s.done) & (s.it < cfg.max_iter)

    def merit_of(prim, dual, mu, p_scale, d_scale):
        return jnp.maximum(
            prim / p_scale, jnp.maximum(dual / d_scale, mu / d_scale)
        )

    def body(s: _S):
        r_eq, r_l, r_u, r_d, mu, prim, dual, _, _ = residuals(s)

        w_l = jnp.clip(jnp.where(has_l, s.lam_l / s.s_l, 0.0), 0.0, _W_MAX)
        w_u = jnp.clip(jnp.where(has_u, s.lam_u / s.s_u, 0.0), 0.0, _W_MAX)
        D = w_l + w_u  # (mi,)
        rho_vec = jnp.concatenate([jnp.zeros(n_eq, dtype), D])
        factor = ops.factorize(rho_vec, sigma_vec, 1.0)

        # Schur columns for equality rows: N^-1 A_eq^T
        NiAeqT = jax.vmap(
            lambda col: ops.kkt_solve(factor, col, rho_vec, sigma_vec, 1.0)
        )(A_eq_T)  # (n_eq, n)
        S_eq = A_eq_T @ NiAeqT.T + cfg.sigma_reg * jnp.eye(n_eq, dtype=dtype)

        def solve_step(r_cl, r_cu):
            """Solve the reduced Newton system for given complementarity
            residuals (r_c = S Lam e - target)."""
            v = (
                jnp.where(has_u, r_cu / s.s_u, 0.0)
                + w_u * r_u
                - jnp.where(has_l, r_cl / s.s_l, 0.0)
                - w_l * r_l
            )
            R = -r_d + rmatvec_with(jnp.zeros(n_eq, dtype), v)
            NiR = ops.kkt_solve(factor, R, rho_vec, sigma_vec, 1.0)
            rhs_eq = A_eq_T @ NiR + r_eq
            dy_eq = jnp.linalg.solve(S_eq, rhs_eq) if n_eq > 0 else s.y_eq[:0]
            dx = NiR - (NiAeqT.T @ dy_eq if n_eq > 0 else 0.0)
            Adx = matvec_A_in(dx)
            ds_l = jnp.where(has_l, Adx + r_l, 0.0)
            ds_u = jnp.where(has_u, r_u - Adx, 0.0)
            dlam_l = jnp.where(has_l, -(r_cl + s.lam_l * ds_l) / s.s_l, 0.0)
            dlam_u = jnp.where(has_u, -(r_cu + s.lam_u * ds_u) / s.s_u, 0.0)
            return dx, dy_eq, ds_l, ds_u, dlam_l, dlam_u

        def max_step(v, dv, mask):
            """Largest a in (0, 1] with v + a dv >= (1 - tau) v on mask."""
            ratio = jnp.where(mask & (dv < 0), -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
            return jnp.minimum(1.0, cfg.tau * jnp.min(ratio, initial=jnp.inf))

        # --- affine (predictor) step ---
        r_cl_aff = s.s_l * s.lam_l
        r_cu_aff = s.s_u * s.lam_u
        dxa, dya, dsla, dsua, dlla, dlua = solve_step(r_cl_aff, r_cu_aff)
        a_p = jnp.minimum(max_step(s.s_l, dsla, has_l), max_step(s.s_u, dsua, has_u))
        a_d = jnp.minimum(
            max_step(s.lam_l, dlla, has_l), max_step(s.lam_u, dlua, has_u)
        )
        mu_aff = (
            jnp.dot(s.s_l + a_p * dsla, s.lam_l + a_d * dlla)
            + jnp.dot(s.s_u + a_p * dsua, s.lam_u + a_d * dlua)
        ) / n_sides
        sig = jnp.clip((mu_aff / (mu + 1e-30)) ** 3, 0.0, 1.0)

        # --- corrector ---
        r_cl = r_cl_aff + dsla * dlla - sig * mu
        r_cl = jnp.where(has_l, r_cl, 0.0)
        r_cu = r_cu_aff + dsua * dlua - sig * mu
        r_cu = jnp.where(has_u, r_cu, 0.0)
        dx, dy_eq, ds_l, ds_u, dlam_l, dlam_u = solve_step(r_cl, r_cu)
        a_p = jnp.minimum(max_step(s.s_l, ds_l, has_l), max_step(s.s_u, ds_u, has_u))
        a_d = jnp.minimum(
            max_step(s.lam_l, dlam_l, has_l), max_step(s.lam_u, dlam_u, has_u)
        )

        x = s.x + a_p * dx
        y_eq = s.y_eq + a_d * dy_eq
        s_l = jnp.where(has_l, s.s_l + a_p * ds_l, 1.0)
        s_u = jnp.where(has_u, s.s_u + a_p * ds_u, 1.0)
        lam_l = jnp.where(has_l, s.lam_l + a_d * dlam_l, 0.0)
        lam_u = jnp.where(has_u, s.lam_u + a_d * dlam_u, 0.0)

        _, _, _, _, mu_new, prim_new, dual_new, p_scale, d_scale = residuals(
            s._replace(x=x, y_eq=y_eq, s_l=s_l, s_u=s_u, lam_l=lam_l, lam_u=lam_u)
        )
        # reject non-finite steps (extreme barrier weights near degeneracy)
        # and terminate at the previous iterate
        ok = jnp.isfinite(mu_new) & jnp.isfinite(prim_new) & jnp.isfinite(dual_new)
        pick = lambda new, old: jnp.where(ok, new, old)
        x = pick(x, s.x)
        y_eq = pick(y_eq, s.y_eq)
        s_l = pick(s_l, s.s_l)
        s_u = pick(s_u, s.s_u)
        lam_l = pick(lam_l, s.lam_l)
        lam_u = pick(lam_u, s.lam_u)
        prim_new = pick(prim_new, prim)
        dual_new = pick(dual_new, dual)
        mu_new = pick(mu_new, mu)

        merit = merit_of(prim_new, dual_new, mu_new, p_scale, d_scale)
        improved = merit < s.best_merit
        bpick = lambda new, old: jnp.where(improved, new, old)
        best = dict(
            best_merit=bpick(merit, s.best_merit),
            best_x=bpick(x, s.best_x),
            best_y_eq=bpick(y_eq, s.best_y_eq),
            best_lam_l=bpick(lam_l, s.best_lam_l),
            best_lam_u=bpick(lam_u, s.best_lam_u),
            best_s_l=bpick(s_l, s.best_s_l),
            best_s_u=bpick(s_u, s.best_s_u),
            best_prim=bpick(prim_new, s.best_prim),
            best_dual=bpick(dual_new, s.best_dual),
            best_gap=bpick(mu_new, s.best_gap),
        )
        diverged = merit > 1e3 * s.best_merit
        done = (merit <= cfg.tol) | jnp.logical_not(ok) | diverged
        return _S(
            x=x,
            y_eq=y_eq,
            s_l=s_l,
            s_u=s_u,
            lam_l=lam_l,
            lam_u=lam_u,
            it=s.it + 1,
            prim_res=prim_new,
            dual_res=dual_new,
            gap=mu_new,
            done=done,
            **best,
        )

    s = lax.while_loop(cond, body, init)

    # return the best iterate seen (equals the final one when converged)
    x_out = s.best_x
    y_out = jnp.concatenate([s.best_y_eq, s.best_lam_u - s.best_lam_l])
    z_out = jnp.clip(ops.matvec_A(x_out), l, u)
    if cfg.polish:
        eq_mask = jnp.arange(m) < n_eq
        pad = jnp.zeros(n_eq, bool)
        lower_active = jnp.concatenate([pad, has_l & (s.best_lam_l > s.best_s_l)])
        upper_active = jnp.concatenate([pad, has_u & (s.best_lam_u > s.best_s_u)])
        x_out, y_out, z_out = _polish(
            ops, q, l, u, x_out, y_out, z_out, cfg,
            eq_mask=eq_mask, active_masks=(lower_active, upper_active),
        )
    return QPSolution(
        x=x_out,
        y=y_out,
        z=z_out,
        iters=s.it,
        prim_res=s.best_prim,
        dual_res=s.best_dual,
        solved=s.best_merit <= cfg.tol,
    )
