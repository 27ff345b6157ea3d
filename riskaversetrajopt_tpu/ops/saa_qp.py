"""Structured SAA SCP subproblem: CVaR epigraph packing + sample-parallel KKT.

The reference assembles, per SCP iteration, a dense-then-sparse OSQP problem
with decision vector z = [us (n_u*S) | ys (M) | slack | t_risk] and row blocks
  [ final rows (n_fc) | CVaR row | -y_i - s rows (M) | per-sample constraint
    blocks (M*K) | slack row | control rows (n_u*S) ]
(car/driving.py:301-373, drone/drone_risk.py:282-374). That matrix is
(1 + M + M*K + ...) x (n_u*S + M + 2): for M = 1000 drone samples it has ~61k
rows — materializing it densely on the device would turn every ADMM iteration
into a 260 MB (f32) sweep of device memory.

Here the QP is represented STRUCTURALLY: the only large object is the stack of
per-sample constraint Jacobians G (M, K, n). All products with A decompose
into one batched einsum over G plus O(M + n) coupling terms, and the ADMM KKT
matrix

    N = P + sigma*I + A^T R A,  R = diag(per-row rho)

factors by a Schur complement over the sample axis: the y-block of N is
diagonal + rank-1 (the CVaR row couples all y_i through an all-ones row), so
eliminating y via Sherman-Morrison reduces the solve to a dense
(n + 2) x (n + 2) system in the coupled variables (u, slack, t) — exactly the
decomposition that distributes over a sample-sharded mesh with one psum
(SURVEY.md sections 5, 7.1.5).

Row-layout, MULTIPLIER row scaling (drone_risk.py:310,353), iteration gating
(car/driving.py:411-415 zero-rows with l *= 0 -> effectively -inf via OSQP's
NaN clamping; drone_risk.py:413-417 scale 1e-7 with bounds +/-0.1), baseline
method variants (incl. the drone baseline's extra 1e-3 safety padding,
drone_risk.py:319-325) all reproduce the reference contracts exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from riskaversetrajopt_tpu.core.config import SCPConfig, SolverConfig
from riskaversetrajopt_tpu.ops import admm
from riskaversetrajopt_tpu.ops import dsjit
from riskaversetrajopt_tpu.ops.rollout import SampleLinearization


class SAAQPStatic(NamedTuple):
    """Static (hashable) problem structure."""

    n: int  # n_u * S control variables
    M: int  # samples
    K: int  # inequality constraints per sample
    n_fc: int  # final (equality) rows
    n_x: int  # state dim — the gating threshold row index (see module doc)
    row_scale: float  # MULTIPLIER on sample rows (drone 0.01, car 1.0)
    slack_penalty: float  # P[-2,-2] and q[-2] (car 1e3, drone 1e4)
    u_max: float
    baseline: bool  # 'baseline' method (no CVaR rows, padded sample rows)
    baseline_pad: float  # drone baseline safety padding (1e-3)
    gate_iters: int
    gate_scale: float  # A-row scale during gated iterations
    gate_l: float  # gated lower bound (-inf for car, -0.1 for drone)
    gate_u: float  # gated upper bound
    # Optional explicit-collective pinning of the sample axis: (Mesh,
    # axis_name). When set, every (M, ...)-leading intermediate inside the
    # operator carries a with_sharding_constraint over that axis, so the
    # Schur-complement split (G/wG/C chip-local, only the (n+2)^2 block and
    # scalar couplings all-reduced) is pinned rather than left to GSPMD's
    # cost model. None = let GSPMD propagate (identical numerics).
    sample_pin: object = None


class SAAQPData(NamedTuple):
    """Per-SCP-iteration numeric data (linearization at the previous iterate)."""

    F: jnp.ndarray  # (n_fc, n) sample-averaged final-constraint Jacobian
    f_rhs: jnp.ndarray  # (n_fc,) equality rhs
    G: jnp.ndarray  # (M, K, n) per-sample constraint Jacobians
    g_up: jnp.ndarray  # (M, K) linearized upper bounds (before row_scale)
    p_diag_u: jnp.ndarray  # (n,) control-block objective diagonal (2*dt*R)
    alpha: jnp.ndarray  # risk level (scalar; traced so alpha sweeps batch)


def pack_saa_qp_data(
    lin: SampleLinearization, us_prev_vec, p_diag_u, alpha
) -> SAAQPData:
    """Build per-iteration QP data from a batched linearization.

    Linearized constraint contract (car/driving.py:289-296):
      equality rows:  F u = mean_i(-f_i + F_i u_prev)  with F = mean_i F_i
      sample rows:    G_i u <= -g_i + G_i u_prev
    """
    F = jnp.mean(lin.f_jac, axis=0)
    f_rhs = jnp.mean(-lin.f_val + lin.f_jac @ us_prev_vec, axis=0)
    g_up = -lin.g_val + lin.g_jac @ us_prev_vec
    return SAAQPData(
        F=F, f_rhs=f_rhs, G=lin.g_jac, g_up=g_up,
        p_diag_u=p_diag_u, alpha=jnp.asarray(alpha, lin.g_jac.dtype),
    )


class _RowScales(NamedTuple):
    """Per-segment A-row scaling implementing iteration gating and the
    baseline-method row shape in fixed layout."""

    c: jnp.ndarray  # scalar, CVaR row
    y: jnp.ndarray  # (M,), -y_i - s rows
    gy: jnp.ndarray  # scalar, multiplies the y/t couplings of sample rows
    g: jnp.ndarray  # scalar, multiplies the whole sample-row blocks
    s: jnp.ndarray  # scalar, slack row


def _segments(st: SAAQPStatic):
    """Static row-segment sizes in reference order."""
    return st.n_fc, 1, st.M, st.M * st.K, 1, st.n


def _row_scales(st: SAAQPStatic, scp_iter, dtype) -> _RowScales:
    gating = scp_iter < st.gate_iters
    gate = jnp.asarray(st.gate_scale, dtype)
    one = jnp.asarray(1.0, dtype)

    # absolute row index >= n_x is gated (see module docstring)
    c_gated = st.n_fc >= st.n_x  # static bool
    y_gated_static = jnp.arange(st.M) >= (st.n_x - st.n_fc - 1)  # (M,)

    c = jnp.where(gating & c_gated, gate, one)
    y = jnp.where(gating & y_gated_static, gate, one)
    g = jnp.where(gating, gate, one)
    s = jnp.where(gating, gate, one)
    if st.baseline:
        # baseline: no CVaR/y/slack rows; sample rows touch only u
        c = c * 0.0
        y = y * 0.0
        s = s * 0.0
        gy = jnp.zeros((), dtype)
    else:
        gy = one
    return _RowScales(c=c, y=y, gy=gy, g=g, s=s)


def build_bounds(st: SAAQPStatic, data: SAAQPData, scp_iter):
    """Assemble (l, u) in reference row order with gating applied."""
    dtype = data.G.dtype
    m = jnp.asarray(st.row_scale, dtype)
    inf = jnp.asarray(jnp.inf, dtype)
    gating = scp_iter < st.gate_iters

    l_final = data.f_rhs
    u_final = data.f_rhs

    def gated(l_norm, u_norm):
        gl = jnp.full_like(l_norm, st.gate_l)
        gu = jnp.full_like(u_norm, st.gate_u)
        return jnp.where(gating, gl, l_norm), jnp.where(gating, gu, u_norm)

    # CVaR row: gated only when its absolute row index >= n_x (true for the
    # drone where n_fc == n_x, false for the car where n_fc = 4 < n_x = 8 —
    # the reference car keeps the CVaR row live at iteration 0)
    c_gated = st.n_fc >= st.n_x
    l_c = jnp.where(
        gating & c_gated, jnp.full(1, st.gate_l, dtype), -inf * jnp.ones(1, dtype)
    )
    u_c = jnp.where(gating & c_gated, jnp.full(1, st.gate_u, dtype), jnp.zeros(1, dtype))
    # y rows gate only where the static row-index mask says so
    y_gated_static = jnp.arange(st.M) >= (st.n_x - st.n_fc - 1)
    l_y = jnp.where(
        gating & y_gated_static, jnp.asarray(st.gate_l, dtype), -inf
    )
    u_y = jnp.where(gating & y_gated_static, jnp.asarray(st.gate_u, dtype), 0.0)

    g_ub = m * (data.g_up - (st.baseline_pad if st.baseline else 0.0))
    l_g, u_g = gated(-inf * jnp.ones(st.M * st.K, dtype), g_ub.reshape(-1))

    l_s, u_s = gated(-inf * jnp.ones(1, dtype), jnp.zeros(1, dtype))

    l_u = jnp.full(st.n, -st.u_max, dtype)
    u_u = jnp.full(st.n, st.u_max, dtype)

    l = jnp.concatenate([l_final, l_c, l_y, l_g, l_s, l_u])
    u = jnp.concatenate([u_final, u_c, u_y, u_g, u_s, u_u])
    return l, u


def build_objective(st: SAAQPStatic, data: SAAQPData):
    """P diagonal and q in variable order [u | y | s | t].

    P has 2*dt*R blocks on the controls and the slack penalty at (-2, -2)
    (car/driving.py:375-389, drone/drone_risk.py:376-391); q is the slack
    penalty at -2."""
    dtype = data.G.dtype
    p_diag = jnp.concatenate(
        [
            data.p_diag_u.astype(dtype),
            jnp.zeros(st.M, dtype),
            jnp.array([st.slack_penalty, 0.0], dtype),
        ]
    )
    q = jnp.zeros(st.n + st.M + 2, dtype).at[-2].set(st.slack_penalty)
    # NOTE: the reference objective does NOT depend on the method — the
    # baseline keeps the slack penalty on an unconstrained slack variable
    # (drone_risk.py:376-391); we reproduce that (it does not affect u*).
    return p_diag, q


class SAAQPOps:
    """Structured operator bundle consumed by ops.admm.admm_solve.

    Variable order z = [u (n) | y (M) | s | t]; row order
    [final | cvar | y-rows | sample blocks | slack | control]."""

    def __init__(self, st: SAAQPStatic, data: SAAQPData, scp_iter,
                 kkt_refine_iters=1, kkt_refine_mode="true",
                 factorize_compensated=None, sweep_precision="highest",
                 kkt_chol_inverse=False):
        # kkt_refine_mode: residual operator for the in-iteration KKT
        # refinement. "true" recomputes N x through matvec_A/rmatvec_A — two
        # extra G-sweeps per pass, i.e. it doubles the memory traffic of the
        # ADMM iteration at M=1000 — and corrects BOTH the triangular-solve
        # roundoff and the factor-formation (einsum-accumulation) error.
        # "factored" computes the residual against the STORED Schur blocks
        # (N_vv, C, D, beta): O(M*(n+2)) traffic (~0.25 MB vs 14.4 MB),
        # corrects the solve roundoff only. With factorize_compensated the
        # stored blocks are formed to a few ulps (per-sample f32 contraction
        # over K, then double-single pairwise reduction over the M axis —
        # ops/dsjit.py), so "factored" matches "true" up to the
        # residual-evaluation noise both modes share — at half the
        # per-iteration memory traffic (2 G-sweeps instead of 4). Without
        # compensated formation (f32 einsum over M*K=63000 terms, ~3e-5
        # relative error, which the factored residual cannot see) "factored"
        # needs more iterations than "true" (PARITY.md round 2).
        # factorize_compensated: None = auto (on for f32, off under x64
        # where plain accumulation is already ~1e-13).
        # kkt_chol_inverse: per-iteration Schur solve via a PRECOMPUTED
        # explicit inverse (one (n+2, n+2) matvec) instead of two
        # sequential triangular solves. A 62-dim solve_triangular is a
        # latency-bound sequential op, and with refinement the kkt_solve
        # runs FOUR of them per ADMM iteration. The inverse is formed once
        # per rho epoch from the jittered Cholesky (cost: one 62-rhs triangular
        # solve pair, amortized over hundreds of iterations); its
        # cond(S)*eps application error is the same order as the
        # triangular solve's and the in-iteration residual refinement
        # contracts both identically.
        self.st = st
        self.kkt_refine_mode = kkt_refine_mode
        self.kkt_chol_inverse = kkt_chol_inverse
        if st.sample_pin is not None:
            data = data._replace(
                G=self._pin_with(st.sample_pin, data.G),
                g_up=self._pin_with(st.sample_pin, data.g_up),
            )
        self.data = data
        self.dtype = data.G.dtype
        if factorize_compensated is None:
            factorize_compensated = self.dtype == jnp.float32
        self.factorize_compensated = factorize_compensated
        self.m = jnp.asarray(st.row_scale, self.dtype)
        self.scales = _row_scales(st, scp_iter, self.dtype)
        self.p_diag, _ = build_objective(st, data)
        self.Malpha = st.M * data.alpha
        self.kkt_refine_iters = kkt_refine_iters
        # Per-iteration G-sweep matmul precision (see SolverConfig.sweep_precision);
        # the factorization einsums below stay HIGHEST/compensated — they run
        # once per rho epoch, not per iteration.
        self.sweep_precision = {
            "highest": lax.Precision.HIGHEST,
            "high": lax.Precision.HIGH,
            "default": lax.Precision.DEFAULT,
        }[sweep_precision]

    @staticmethod
    def _pin_with(pin, x):
        from jax.sharding import NamedSharding, PartitionSpec

        mesh, axis = pin
        spec = PartitionSpec(*((axis,) + (None,) * (x.ndim - 1)))
        return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))

    def _pin(self, x):
        """Pin an (M, ...)-leading intermediate to the sample axis."""
        if self.st.sample_pin is None:
            return x
        return self._pin_with(self.st.sample_pin, x)

    # -- pieces ------------------------------------------------------------
    def _split_z(self, z):
        n, M = self.st.n, self.st.M
        return z[:n], z[n : n + M], z[n + M], z[n + M + 1]

    def _split_w(self, w):
        st = self.st
        seg = _segments(st)
        w_f = w[: seg[0]]
        o = seg[0]
        w_c = w[o]
        o += 1
        w_y = w[o : o + st.M]
        o += st.M
        w_G = w[o : o + st.M * st.K].reshape(st.M, st.K)
        o += st.M * st.K
        w_s = w[o]
        o += 1
        w_u = w[o:]
        return w_f, w_c, w_y, w_G, w_s, w_u

    # -- ADMM operator interface ------------------------------------------
    def matvec_P(self, z):
        return self.p_diag * z

    def matvec_A(self, z):
        st, sc, m = self.st, self.scales, self.m
        u, y, s, t = self._split_z(z)
        r_final = self.data.F @ u
        # CVaR row: sum(y) + s + M*alpha*t <= 0 — the reference sets columns
        # n_u*S through -2 INCLUSIVE to 1.0, which covers the slack column
        # (car/driving.py:341-342 `.at[0, (n_u*S):-1].set(1.0)`,
        # drone/drone_risk.py:336-337)
        r_c = sc.c * (jnp.sum(y) + s + self.Malpha * t)
        r_y = sc.y * (-y - s)
        # sample rows: m*(G_i u - gy*(y_i + t)) (gy=0 for baseline)
        Gu = self._pin(
            jnp.einsum("mkn,n->mk", self.data.G, u,
                       precision=self.sweep_precision)
        )
        r_G = sc.g * m * (Gu - sc.gy * (y[:, None] + t))
        r_s = sc.s * (-s)
        r_u = u
        return jnp.concatenate(
            [r_final, r_c[None], r_y, r_G.reshape(-1), r_s[None], r_u]
        )

    def rmatvec_A(self, w):
        st, sc, m = self.st, self.scales, self.m
        w_f, w_c, w_y, w_G, w_s, w_u = self._split_w(w)
        wG = self._pin(sc.g * m * w_G)  # (M, K) effective sample-row weights
        u_part = (
            self.data.F.T @ w_f
            + jnp.einsum("mkn,mk->n", self.data.G, wG,
                         precision=self.sweep_precision)
            + w_u
        )
        row_sums = jnp.sum(wG, axis=1)  # (M,)
        y_part = sc.c * w_c - sc.y * w_y - sc.gy * row_sums
        s_part = sc.c * w_c - jnp.sum(sc.y * w_y) - sc.s * w_s
        t_part = sc.c * self.Malpha * w_c - sc.gy * jnp.sum(row_sums)
        return jnp.concatenate([u_part, y_part, s_part[None], t_part[None]])

    # -- Ruiz structural norms --------------------------------------------
    def _split_D(self, D):
        n, M = self.st.n, self.st.M
        return D[:n], D[n : n + M], D[n + M], D[n + M + 1]

    def row_inf_norms(self, D):
        """max_j |A_ij| D_j per row, computed segment-wise without
        materializing A."""
        st, sc, m = self.st, self.scales, self.m
        D_u, D_y, D_s, D_t = self._split_D(D)
        r_final = jnp.max(jnp.abs(self.data.F) * D_u[None, :], axis=1)
        r_c = sc.c * jnp.maximum(
            jnp.maximum(jnp.max(D_y), D_s), self.Malpha * D_t
        )
        r_y = sc.y * jnp.maximum(D_y, D_s)
        gu = jnp.max(jnp.abs(self.data.G) * D_u[None, None, :], axis=2)  # (M,K)
        r_G = sc.g * m * jnp.maximum(
            gu, sc.gy * jnp.maximum(D_y[:, None], D_t)
        )
        r_s = sc.s * D_s
        r_u = D_u
        return jnp.concatenate(
            [r_final, r_c[None], r_y, r_G.reshape(-1), r_s[None], r_u]
        )

    def col_inf_norms(self, E):
        """max_i E_i |A_ij| per column, segment-wise."""
        st, sc, m = self.st, self.scales, self.m
        E_f, E_c, E_y, E_G, E_s, E_u = self._split_w(E)
        c_u = jnp.maximum(
            jnp.max(jnp.abs(self.data.F) * E_f[:, None], axis=0),
            jnp.maximum(
                sc.g * m * jnp.max(jnp.abs(self.data.G) * E_G[:, :, None], axis=(0, 1)),
                E_u,
            ),
        )
        c_y = jnp.maximum(
            sc.c * E_c,
            jnp.maximum(sc.y * E_y, sc.g * m * sc.gy * jnp.max(E_G, axis=1)),
        )
        c_s = jnp.maximum(
            sc.c * E_c, jnp.maximum(jnp.max(sc.y * E_y), sc.s * E_s)
        )
        c_t = jnp.maximum(
            sc.c * self.Malpha * E_c, sc.g * m * sc.gy * jnp.max(E_G)
        )
        return jnp.concatenate([c_u, c_y, c_s[None], c_t[None]])

    def col_inf_norms_P(self, D):
        return self.p_diag * D  # P is diagonal

    # -- KKT factorization: Schur complement over samples ------------------
    def _rho_segments(self, rho_vec):
        return self._split_w(rho_vec)

    def factorize(self, rho_vec, sigma_vec, cost_scale=1.0):
        """Factor N = c*P + diag(sigma) + A^T R A by eliminating the y-block.

        y-block: N_yy = D + beta * 11^T with
          D_i = sigma_y_i + rho_y_i*sc_y_i^2 + gy^2 m^2 sum_k rho_G_ik
          beta = rho_c * sc_c^2
        Coupled block v = (u, s, t) solved densely after Sherman-Morrison
        elimination of y."""
        st, sc, m = self.st, self.scales, self.m
        data = self.data
        n, M, K = st.n, st.M, st.K
        rho_f, rho_c, rho_y, rho_G, rho_s, rho_u = self._rho_segments(rho_vec)
        sigma_u, sigma_y, sigma_s, sigma_t = self._split_D(sigma_vec)
        dtype = self.dtype

        g2 = (sc.g * m) ** 2  # effective squared sample-row scale
        wG = self._pin(g2 * rho_G)  # (M, K)
        rowsum_wG = jnp.sum(wG, axis=1)  # (M,)

        # Compensated formation: every reduction over the M sample axis goes
        # through a double-single pairwise sum (ops/dsjit.py). The per-sample
        # contractions over K stay plain f32 (K ~ 63 terms, a-few-ulp error);
        # the M = 1000-term accumulation — the ~3e-5-relative error the
        # "factored" refinement mode cannot observe — is what compensation
        # removes. Cost: one (M, n, n) intermediate + log2(M) folds, paid only
        # at refactorization epochs.
        comp = self.factorize_compensated

        def msum(x):
            """Sum over the leading M axis (compensated when enabled)."""
            if comp:
                return dsjit.ds_round(*dsjit.sum1_ds(x, axis=0))
            return jnp.sum(x, axis=0)

        # --- y block ---
        D = sigma_y + rho_y * sc.y**2 + sc.gy**2 * rowsum_wG  # (M,)
        beta = rho_c * sc.c**2

        # --- coupled block N_vv (v = [u, s, t]) ---
        # uu: c*P_u + sigma_u + F^T Rf F + sum_i G_i^T diag(wG_i) G_i + rho_u
        if comp:
            B = msum(jnp.einsum(
                "mkn,mk,mkp->mnp", data.G, wG, data.G,
                precision=lax.Precision.HIGHEST,
            ))
        else:
            B = jnp.einsum(
                "mkn,mk,mkp->np", data.G, wG, data.G,
                precision=lax.Precision.HIGHEST,
            )
        N_uu = (
            jnp.diag(cost_scale * self.p_diag[:n] + sigma_u + rho_u)
            + data.F.T @ (rho_f[:, None] * data.F)
            + B
        )
        # per-sample rows G_i^T wG_i (M, n): reduced over M for the u-t
        # coupling, kept per-sample as the y-v coupling C_u below
        GtwG = jnp.einsum(
            "mkn,mk->mn", data.G, wG, precision=lax.Precision.HIGHEST
        )
        Gw = msum(GtwG)  # sum_i G_i^T wG_i 1
        N_ut = -sc.gy * Gw  # (n,)
        N_us = jnp.zeros(n, dtype)
        # ss: sigma_s + c*P_ss + sum_i rho_y sc_y^2 + rho_s sc_s^2 + beta
        # (the CVaR row sum(y)+s+Malpha*t contributes rho_c*a a^T with
        #  a = sc_c*[1_M | 1 | Malpha] over (y, s, t))
        N_ss = (
            cost_scale * self.p_diag[n + M]
            + sigma_s
            + msum(rho_y * sc.y**2)
            + rho_s * sc.s**2
            + beta
        )
        N_tt = (
            sigma_t
            + beta * self.Malpha**2
            + sc.gy**2 * msum(rowsum_wG)
        )
        N_st = beta * self.Malpha

        N_vv = jnp.zeros((n + 2, n + 2), dtype)
        N_vv = N_vv.at[:n, :n].set(N_uu)
        N_vv = N_vv.at[:n, n].set(N_us)
        N_vv = N_vv.at[n, :n].set(N_us)
        N_vv = N_vv.at[:n, n + 1].set(N_ut)
        N_vv = N_vv.at[n + 1, :n].set(N_ut)
        N_vv = N_vv.at[n, n].set(N_ss)
        N_vv = N_vv.at[n, n + 1].set(N_st)
        N_vv = N_vv.at[n + 1, n].set(N_st)
        N_vv = N_vv.at[n + 1, n + 1].set(N_tt)

        # --- y-v coupling C (M, n+2): row i = [C_u_i | C_s_i | C_t_i] ---
        # y_i - u: -gy * G_i^T wG_i  (n,) — wG is already sample-pinned, so
        # GtwG carries the pinning; _pin kept for when sample_pin re-masks
        C_u = self._pin(-sc.gy * GtwG)  # (M, n)
        # y_i - s: rho_y_i sc_y_i^2 (from the -y_i - s rows) + beta (CVaR row)
        C_s = (rho_y * sc.y**2 + beta)[:, None]  # (M, 1)
        # y_i - t: beta*Malpha + gy^2 * rowsum_wG_i
        C_t = (beta * self.Malpha + sc.gy**2 * rowsum_wG)[:, None]
        C = jnp.concatenate([C_u, C_s, C_t], axis=1)  # (M, n+2)

        # --- Schur complement S = N_vv - C^T Nyy^-1 C via Sherman-Morrison ---
        Dinv = 1.0 / D
        DinvC = Dinv[:, None] * C  # (M, n+2)
        if comp:
            p, e = dsjit.two_prod(C[:, :, None], DinvC[:, None, :])
            CtDinvC = dsjit.ds_round(*dsjit.ds_sum(p, e, axis=0))
        else:
            CtDinvC = C.T @ DinvC
        one_DinvC = msum(DinvC)  # (n+2,) = 1^T D^-1 C
        denom = 1.0 + beta * msum(Dinv)
        S = N_vv - (CtDinvC - (beta / denom) * jnp.outer(one_DinvC, one_DinvC))
        # f32 safeguard: the Schur subtraction can lose positive-definiteness
        # to roundoff under extreme barrier/penalty weights; escalate a
        # trace-scaled jitter until the Cholesky is finite
        base = jnp.asarray(1e-7 if dtype == jnp.float32 else 0.0, dtype)
        scale = jnp.mean(jnp.diag(S))
        eye_v = jnp.eye(n + 2, dtype=dtype)

        def jcond(carry):
            jit_f, chol = carry
            return jnp.any(jnp.isnan(chol)) & (jit_f < 1e-1)

        def jstep(carry):
            jit_f, _ = carry
            jit_f = jnp.maximum(jit_f * 100.0, 1e-6)
            return jit_f, jnp.linalg.cholesky(S + jit_f * scale * eye_v)

        chol0 = jnp.linalg.cholesky(S + base * scale * eye_v)
        _, chol_S = jax.lax.while_loop(jcond, jstep, (base, chol0))
        if self.kkt_chol_inverse:
            # explicit S^-1 for the matvec per-iteration solve (see
            # __init__): one batched 62-rhs triangular solve pair per rho
            # epoch replaces 4 sequential solves per ADMM iteration
            t1 = jax.scipy.linalg.solve_triangular(chol_S, eye_v, lower=True)
            S_op = jax.scipy.linalg.solve_triangular(
                chol_S.T, t1, lower=False
            )
        else:
            S_op = chol_S
        # Sherman-Morrison denominator 1 + beta * sum(1/D): loop-invariant
        # per factorization; with kkt_refine_iters=1 the iteration calls
        # _solve_yy 8x, and each (M,)-reduction is pure latency
        denom_yy = 1.0 + beta * jnp.sum(1.0 / D)
        # N_vv rides along for the "factored" refinement mode (tiny:
        # (n+2)^2); unused by mode "true"
        return (S_op, C, D, beta, N_vv, denom_yy)

    def _solve_yy(self, D, beta, r, denom=None):
        """(D + beta 11^T)^-1 r via Sherman-Morrison. `denom` (the scalar
        1 + beta sum(1/D)) is precomputed at factorization when available —
        bitwise the same value, computed once per rho epoch instead of on
        every call in the hot loop."""
        Dinv_r = r / D
        if denom is None:
            denom = 1.0 + beta * jnp.sum(1.0 / D)
        return Dinv_r - (beta * jnp.sum(Dinv_r) / denom) / D

    def kkt_solve(self, factor, rhs, rho_vec, sigma_vec, cost_scale=1.0):
        S_op, C, D, beta, N_vv, denom_yy = factor
        n, M = self.st.n, self.st.M
        r_u = rhs[:n]
        r_y = rhs[n : n + M]
        r_st = rhs[n + M :]
        r_v = jnp.concatenate([r_u, r_st])

        def solve_once(r_v, r_y):
            Nyy_inv_ry = self._solve_yy(D, beta, r_y, denom_yy)
            rhs_v = r_v - C.T @ Nyy_inv_ry
            if self.kkt_chol_inverse:
                v = S_op @ rhs_v  # S_op = S^-1 (see factorize)
            else:
                t1 = jax.scipy.linalg.solve_triangular(
                    S_op, rhs_v, lower=True
                )
                v = jax.scipy.linalg.solve_triangular(
                    S_op.T, t1, lower=False
                )
            y = self._solve_yy(D, beta, r_y - C @ v, denom_yy)
            return v, y

        def residual_true(x):
            return rhs - (
                cost_scale * self.matvec_P(x)
                + sigma_vec * x
                + self.rmatvec_A(rho_vec * self.matvec_A(x))
            )

        def residual_factored(v, y):
            # N x through the stored blocks: N = [[N_vv, C^T], [C, D+b11^T]]
            Nx_v = N_vv @ v + C.T @ y
            Nx_y = C @ v + D * y + beta * jnp.sum(y)
            return jnp.concatenate([r_v - Nx_v, r_y - Nx_y])

        v, y = solve_once(r_v, r_y)
        x = jnp.concatenate([v[:n], y, v[n:]])
        for _ in range(self.kkt_refine_iters):
            if self.kkt_refine_mode == "factored":
                rf = residual_factored(jnp.concatenate([x[:n], x[n + M:]]),
                                       x[n : n + M])
                res_v, res_y = rf[: n + 2], rf[n + 2 :]
            else:
                res = residual_true(x)
                res_v = jnp.concatenate([res[:n], res[n + M :]])
                res_y = res[n : n + M]
            dv, dy = solve_once(res_v, res_y)
            x = x + jnp.concatenate([dv[:n], dy, dv[n:]])
        return x


def solve_saa_qp(
    st: SAAQPStatic,
    data: SAAQPData,
    scp_iter,
    cfg: SolverConfig,
    x0=None,
    y0=None,
    scale: bool = True,
    ruiz_iters: int = 5,
    rho0=None,
    eps_scale=None,
) -> admm.QPSolution:
    """Solve one SCP subproblem with the structured operator."""
    ops = SAAQPOps(
        st, data, scp_iter, kkt_refine_iters=cfg.kkt_refine_iters,
        kkt_refine_mode=getattr(cfg, "kkt_refine_mode", "true"),
        sweep_precision=getattr(cfg, "sweep_precision", "highest"),
        kkt_chol_inverse=getattr(cfg, "kkt_chol_inverse", False),
    )
    _, q = build_objective(st, data)
    l, u = build_bounds(st, data, scp_iter)
    scaling = admm.ruiz_equilibrate(ops, q, l, u, iters=ruiz_iters) if scale else None
    return admm.admm_solve(ops, q, l, u, cfg, x0=x0, y0=y0, scaling=scaling,
                           rho0=rho0, eps_scale=eps_scale)
