"""Iterative refinement for the structured SAA QP: true 1e-6..1e-8
KKT residuals from f32-only arithmetic.

Plain f32 ADMM stalls near unscaled residuals of ~1e-5 at M=1000 (the
iterate update and the residual evaluation both round at ~6e-8 relative of
O(1..10) magnitudes), while golden-trajectory tracking needs QP solves at
eps<=1e-6 (scp/driver.py: the SCP endpoint error amplifies the QP
tolerance ~1000x through the post-gating transition iterations). The
reference sidesteps this by running OSQP in f64 on CPU
(car/driving.py:13-18). This module closes the gap without f64 units,
with QP-level iterative refinement in the style of
Gleixner-et-al. LP/QP refinement:

1. solve the QP with the ordinary f32 structured ADMM to its reliable
   tolerance (the "base" solve);
2. compute the exact residual data at the incumbent (x0, y0) with
   compensated double-single arithmetic (ops/dsjit.py — jit-safe,
   FMA-immune):
       r_d = P x0 + q + A^T y0        (dual residual vector)
       r_l = l - A x0,  r_u = u - A x0 (signed primal slacks)
3. solve the CORRECTION QP with the SAME operator and Ruiz scaling,
       min 1/2 dx P dx + (Delta r_d)^T dx   s.t.  Delta r_l <= A dx <= Delta r_u,
   where Delta is a power of two (exact scaling) chosen so the correction
   data is O(1) — the f32 solver now works at its full RELATIVE precision
   on data that encodes absolutely-tiny residuals;
4. update x <- x0 + dx/Delta (double-single accumulation),
   y <- y0 + w/Delta, and repeat. Substituting the correction KKT
   conditions shows stationarity holds EXACTLY for the updated pair:
       P dx + Delta r_d + A^T w = 0
   <=> P(x0 + dx/Delta) + q + A^T (y0 + w/Delta) = (correction dual
       residual)/Delta,
   i.e. each round contracts the true residuals by ~(correction solve
   accuracy)/Delta. Complementarity transfers because ADMM's inactive-row
   duals are exactly zero (the z-projection is the identity there).

The correction solve is warm-started at dx = 0, w = 0 — i.e. at the
incumbent — which preserves the prox-to-previous-iterate bias that makes
warm-started ADMM track the reference's OSQP trajectory through the
degenerate post-gating QPs (see tests/test_reference_parity.py).

Termination is certified with compensated UNSCALED residuals (OSQP
criterion, scaled_termination=False semantics), so `solved` is honest at
tolerances far below the f32 representation floor.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from riskaversetrajopt_tpu.core.config import SolverConfig
from riskaversetrajopt_tpu.ops import admm
from riskaversetrajopt_tpu.ops import dsjit as ds
from riskaversetrajopt_tpu.ops.saa_qp import (
    SAAQPOps,
    SAAQPStatic,
    build_bounds,
    build_objective,
)


class IRConfig(NamedTuple):
    """Refinement knobs. `rounds` correction solves run after the base
    solve; each is skipped (lax.cond) once the certified residuals meet
    the target."""

    rounds: int = 4
    #: tolerance of the correction ADMM solves (the reliable f32 working
    #: tolerance; the TARGET tolerance is SolverConfig.eps_abs/rel)
    work_eps: float = 3e-4
    #: base-solve tolerances; None = work_eps. Setting these to the TARGET
    #: tolerances (with base_max_iter bounding the f32 stall) keeps the
    #: base on the warm-started-ADMM path that selects the reference's
    #: solution branch — the corrections then only certify the tail,
    #: instead of navigating the degenerate face themselves (which lands
    #: on a different, typically far more conservative branch: measured
    #: M=1000 cost 1.7-4.6 vs the golden's 0.476).
    base_eps_abs: float = None
    base_eps_rel: float = None
    base_max_iter: int = None
    #: residual->Delta headroom: Delta ~= 2^round(log2(margin/res))
    margin: float = 0.1
    delta_max: float = 1e10
    #: proximal weight added to the correction QP's objective,
    #: min 1/2 dx (P + prox I) dx + ...: the post-gating QPs have
    #: degenerate optimal faces, and an un-regularized correction solve
    #: wanders O(face diameter) along them (measured |dx|/Delta ~ 0.2 per
    #: round at M=50), destroying the warm-started-ADMM solution branch
    #: that tracks the reference's OSQP trajectory. With the prox term the
    #: correction is (approximately) the PROJECTION of the incumbent onto
    #: the optimal face. The prox contribution shows up honestly in the
    #: certified outer dual residual (prox*|dx|/Delta per round), so it
    #: slows contraction but cannot fake convergence.
    prox: float = 1e-3


def _ds_chunk(M):
    """Sample-axis chunk size for the compensated G contractions.

    The unchunked compensated sweep materializes ~4 full (M, K, n)
    intermediates plus the pairwise-reduction ladder; past M ~ 512
    (drone shapes) that working set stopped fitting the fusion budget of
    the accelerator this was first built for, where chunk 128 measured
    best; not measured on the H100."""
    return 128 if M > 256 else None


def _ds_matvec_A(ops: SAAQPOps, x_h, x_l):
    """Compensated matvec_A of a ds vector; mirrors SAAQPOps.matvec_A
    (row order [final | cvar | y | sample | slack | control])."""
    st, sc = ops.st, ops.scales
    n, M = st.n, st.M
    u_h, y_h = x_h[:n], x_h[n:n + M]
    u_l, y_l = x_l[:n], x_l[n:n + M]
    s_h, s_l = x_h[n + M], x_l[n + M]
    t_h, t_l = x_h[n + M + 1], x_l[n + M + 1]

    # final rows: F @ u
    ph, pe = ds.two_prod(ops.data.F, u_h[None, :])
    pe = pe + ops.data.F * u_l[None, :]
    rf_h, rf_l = ds.ds_sum(ph, pe, axis=1)

    # CVaR row: c * (sum(y) + s + M*alpha*t)
    sy_h, sy_l = ds.ds_sum(y_h, y_l, axis=0)
    ma_h, ma_l = ds.two_prod(jnp.asarray(float(st.M), x_h.dtype), ops.data.alpha)
    mat_h, mat_l = ds.ds_mul(ma_h, ma_l, t_h, t_l)
    rc_h, rc_l = ds.ds_add(sy_h, sy_l, s_h, s_l)
    rc_h, rc_l = ds.ds_add(rc_h, rc_l, mat_h, mat_l)
    rc_h, rc_l = ds.ds_scale(rc_h, rc_l, sc.c)

    # y rows: sc.y * (-y - s)
    ry_h, ry_l = ds.ds_add(-y_h, -y_l, -s_h, -s_l)
    ry_h, ry_l = ds.ds_scale(ry_h, ry_l, sc.y)

    # sample rows: (g*m) * (G u - gy*(y + t))
    gu_h, gu_l = ds.contract_mkn_n(ops.data.G, u_h, u_l,
                                   chunk=_ds_chunk(st.M))
    yt_h, yt_l = ds.ds_add(
        y_h[:, None], y_l[:, None],
        jnp.broadcast_to(t_h, (M, 1)), jnp.broadcast_to(t_l, (M, 1)),
    )
    yt_h, yt_l = ds.ds_scale(yt_h, yt_l, sc.gy)
    rg_h, rg_l = ds.ds_add(gu_h, gu_l, -yt_h, -yt_l)
    gm_h, gm_l = ds.two_prod(sc.g, ops.m)
    rg_h, rg_l = ds.ds_mul(
        rg_h, rg_l, jnp.broadcast_to(gm_h, rg_h.shape),
        jnp.broadcast_to(gm_l, rg_h.shape),
    )

    rs_h, rs_l = ds.ds_scale(-s_h, -s_l, sc.s)

    h = jnp.concatenate([
        rf_h, rc_h[None], ry_h, rg_h.reshape(-1), rs_h[None], u_h,
    ])
    lo = jnp.concatenate([
        rf_l, rc_l[None], ry_l, rg_l.reshape(-1), rs_l[None], u_l,
    ])
    return h, lo


def _ds_rmatvec_A(ops: SAAQPOps, w, w_lo=None):
    """Compensated rmatvec_A of a dual vector w; pass `w_lo` for a full
    double-single (w, w_lo) input (ops/admm_ds.py), else w is plain f32."""
    st, sc = ops.st, ops.scales
    w_f, w_c, w_y, w_G, w_s, w_u = ops._split_w(w)
    if w_lo is None:
        w_lo = jnp.zeros_like(w)
    wl_f, wl_c, wl_y, wl_G, wl_s, wl_u = ops._split_w(w_lo)

    gm_h, gm_l = ds.two_prod(sc.g, ops.m)
    wg_h, wg_l = ds.ds_mul(
        jnp.broadcast_to(gm_h, w_G.shape), jnp.broadcast_to(gm_l, w_G.shape),
        w_G, wl_G,
    )

    # u part: F^T w_f + einsum(G, wG) + w_u
    ph, pe = ds.two_prod(ops.data.F, w_f[:, None])
    pe = pe + ops.data.F * wl_f[:, None]
    ftw_h, ftw_l = ds.ds_sum(ph, pe, axis=0)
    gtw_h, gtw_l = ds.contract_mkn_mk(ops.data.G, wg_h, wg_l,
                                      chunk=_ds_chunk(st.M))
    u_h, u_l = ds.ds_add(ftw_h, ftw_l, gtw_h, gtw_l)
    u_h, u_l = ds.ds_add(u_h, u_l, w_u, wl_u)

    rows_h, rows_l = ds.ds_sum(wg_h, wg_l, axis=1)  # (M,)

    cw_h, cw_l = ds.ds_scale(w_c, wl_c, sc.c)
    yw_h, yw_l = ds.ds_scale(w_y, wl_y, sc.y)
    gy_rows_h, gy_rows_l = ds.ds_scale(rows_h, rows_l, sc.gy)
    y_h, y_l = ds.ds_add(
        jnp.broadcast_to(cw_h, (st.M,)), jnp.broadcast_to(cw_l, (st.M,)),
        -yw_h, -yw_l,
    )
    y_h, y_l = ds.ds_add(y_h, y_l, -gy_rows_h, -gy_rows_l)

    syw_h, syw_l = ds.ds_sum(yw_h, yw_l, axis=0)
    sw_h, sw_l = ds.ds_scale(w_s, wl_s, sc.s)
    s_h, s_l = ds.ds_add(cw_h, cw_l, -syw_h, -syw_l)
    s_h, s_l = ds.ds_add(s_h, s_l, -sw_h, -sw_l)

    ma_h, ma_l = ds.two_prod(jnp.asarray(float(st.M), w.dtype), ops.data.alpha)
    cma_h, cma_l = ds.ds_mul(
        ma_h, ma_l, jnp.broadcast_to(cw_h, ()), jnp.broadcast_to(cw_l, ()),
    )
    srows_h, srows_l = ds.ds_sum(gy_rows_h, gy_rows_l, axis=0)
    t_h, t_l = ds.ds_add(cma_h, cma_l, -srows_h, -srows_l)

    h = jnp.concatenate([u_h, y_h, s_h[None], t_h[None]])
    lo = jnp.concatenate([u_l, y_l, s_l[None], t_l[None]])
    return h, lo


def _ds_sub_bound(b, ax_h, ax_l):
    """Compensated b - Ax with +/-inf rows passed through."""
    s_h, s_e = ds.two_sum(b, -ax_h)
    fin = jnp.isfinite(b)
    h = jnp.where(fin, s_h, b)
    lo = jnp.where(fin, s_e - ax_l, 0.0)
    return h, lo


class _Residuals(NamedTuple):
    prim: jnp.ndarray
    dual: jnp.ndarray
    eps_prim: jnp.ndarray
    eps_dual: jnp.ndarray
    rd_h: jnp.ndarray
    rd_l: jnp.ndarray
    rl_h: jnp.ndarray
    rl_l: jnp.ndarray
    ru_h: jnp.ndarray
    ru_l: jnp.ndarray


def _residuals(ops, q, l, u, p_diag, x_h, x_l, y, cfg):
    """Compensated unscaled OSQP residuals at (x, y) with z = clip(Ax)."""
    ax_h, ax_l = _ds_matvec_A(ops, x_h, x_l)

    px_h, px_e = ds.two_prod(p_diag, x_h)
    px_e = px_e + p_diag * x_l
    rd_h, rd_l = ds.ds_add(px_h, px_e, q, jnp.zeros_like(q))
    aty_h, aty_l = _ds_rmatvec_A(ops, y)
    rd_h, rd_l = ds.ds_add(rd_h, rd_l, aty_h, aty_l)

    rl_h, rl_l = _ds_sub_bound(l, ax_h, ax_l)  # l - Ax
    ru_h, ru_l = _ds_sub_bound(u, ax_h, ax_l)  # u - Ax

    viol = jnp.maximum(
        jnp.where(jnp.isfinite(l), ds.ds_round(rl_h, rl_l), -jnp.inf),
        jnp.where(jnp.isfinite(u), ds.ds_round(-ru_h, -ru_l), -jnp.inf),
    )
    prim = jnp.max(jnp.maximum(viol, 0.0))
    dual = jnp.max(jnp.abs(ds.ds_round(rd_h, rd_l)))

    ax = ds.ds_round(ax_h, ax_l)
    z = jnp.clip(ax, l, u)
    eps_prim = cfg.eps_abs + cfg.eps_rel * jnp.maximum(
        jnp.max(jnp.abs(ax)), jnp.max(jnp.abs(z))
    )
    eps_dual = cfg.eps_abs + cfg.eps_rel * jnp.maximum(
        jnp.maximum(
            jnp.max(jnp.abs(ds.ds_round(px_h, px_e))),
            jnp.max(jnp.abs(ds.ds_round(aty_h, aty_l))),
        ),
        jnp.max(jnp.abs(q)),
    )
    return _Residuals(prim, dual, eps_prim, eps_dual,
                      rd_h, rd_l, rl_h, rl_l, ru_h, ru_l)


def _pow2(x):
    """Round a positive scalar to the nearest power of two (exact scale)."""
    return jnp.exp2(jnp.round(jnp.log2(x)))


def _ds_matvec_dense(Amat, x_h, x_l):
    """Compensated Amat @ (x_h, x_l) for a dense matrix (ds output)."""
    p, e = ds.two_prod(Amat, x_h[None, :])
    e = e + Amat * x_l[None, :]
    return ds.ds_sum(p, e, axis=1)


def _ds_rmatvec_dense(Amat, w, w_lo=None):
    """Compensated Amat.T @ (w, w_lo) for a dense matrix (ds output)."""
    p, e = ds.two_prod(Amat, w[:, None])
    if w_lo is not None:
        e = e + Amat * w_lo[:, None]
    return ds.ds_sum(p, e, axis=0)


def _residuals_dense(P, A, q, l, u, x_h, x_l, y, cfg, y_l=None):
    """Compensated unscaled OSQP residuals for a DENSE (P, A) QP at
    (x, y) with z = clip(Ax) — the dense analog of `_residuals`. `y` may
    be a ds pair via `y_l` (the refinement loop carries the dual in ds:
    its corrections fall below ulp(y) once the dual residual reaches
    ~eps_f32 * |y|, which plain-f32 accumulation cannot represent —
    measured stall at 1.7e-7 on the car-Gaussian alpha rows)."""
    ax_h, ax_l = _ds_matvec_dense(A, x_h, x_l)
    px_h, px_l = _ds_matvec_dense(P, x_h, x_l)
    rd_h, rd_l = ds.ds_add(px_h, px_l, q, jnp.zeros_like(q))
    aty_h, aty_l = _ds_rmatvec_dense(A, y, y_l)
    rd_h, rd_l = ds.ds_add(rd_h, rd_l, aty_h, aty_l)

    rl_h, rl_l = _ds_sub_bound(l, ax_h, ax_l)
    ru_h, ru_l = _ds_sub_bound(u, ax_h, ax_l)

    viol = jnp.maximum(
        jnp.where(jnp.isfinite(l), ds.ds_round(rl_h, rl_l), -jnp.inf),
        jnp.where(jnp.isfinite(u), ds.ds_round(-ru_h, -ru_l), -jnp.inf),
    )
    prim = jnp.max(jnp.maximum(viol, 0.0))
    dual = jnp.max(jnp.abs(ds.ds_round(rd_h, rd_l)))

    ax = ds.ds_round(ax_h, ax_l)
    z = jnp.clip(ax, l, u)
    eps_prim = cfg.eps_abs + cfg.eps_rel * jnp.maximum(
        jnp.max(jnp.abs(ax)), jnp.max(jnp.abs(z))
    )
    eps_dual = cfg.eps_abs + cfg.eps_rel * jnp.maximum(
        jnp.maximum(
            jnp.max(jnp.abs(ds.ds_round(px_h, px_l))),
            jnp.max(jnp.abs(ds.ds_round(aty_h, aty_l))),
        ),
        jnp.max(jnp.abs(q)),
    )
    return _Residuals(prim, dual, eps_prim, eps_dual,
                      rd_h, rd_l, rl_h, rl_l, ru_h, ru_l)


def solve_dense_qp_ir(
    P,
    q,
    A,
    l,
    u,
    cfg: SolverConfig,
    ir: IRConfig = IRConfig(),
    x0=None,
    y0=None,
    ruiz_iters: int = 5,
) -> admm.QPSolution:
    """Dense-matrix analog of `solve_saa_qp_ir`: f32 ADMM base solve +
    Gleixner-style correction rounds with compensated residuals, certified
    at cfg.eps_abs/eps_rel far below the f32 floor.

    This is the f32 path for the Gaussian-baseline planners' SCP QPs —
    the reference solves those with OSQP at eps 1e-8 on CPU x64
    (car/driving_gaussian.py:27), which plain f32 ADMM (or IPM) cannot
    certify; the refinement loop recovers the accuracy from f32-only
    arithmetic."""
    ops = admm.DenseQPOps(P, A, kkt_refine_iters=cfg.kkt_refine_iters)
    dtype = q.dtype
    scaling = admm.ruiz_equilibrate(ops, q, l, u, iters=ruiz_iters)

    import dataclasses

    work_cfg = dataclasses.replace(
        cfg, eps_abs=ir.work_eps, eps_rel=ir.work_eps, polish=False
    )
    base_cfg = dataclasses.replace(
        cfg,
        eps_abs=ir.base_eps_abs if ir.base_eps_abs is not None else ir.work_eps,
        eps_rel=ir.base_eps_rel if ir.base_eps_rel is not None else ir.work_eps,
        max_iter=(
            ir.base_max_iter if ir.base_max_iter is not None else cfg.max_iter
        ),
        polish=False,
    )
    base = admm.admm_solve(ops, q, l, u, base_cfg, x0=x0, y0=y0,
                           scaling=scaling)
    x_h, x_l = base.x, jnp.zeros_like(base.x)
    y_h, y_lo = base.y, jnp.zeros_like(base.y)
    iters = base.iters

    res = _residuals_dense(P, A, q, l, u, x_h, x_l, y_h, cfg, y_l=y_lo)

    for _ in range(ir.rounds):
        done = (res.prim <= res.eps_prim) & (res.dual <= res.eps_dual)

        def do_round(x_h, x_l, y_h, y_lo, res, iters):
            scale = jnp.maximum(
                jnp.maximum(res.prim, res.dual), jnp.asarray(1e-30, dtype)
            )
            delta = _pow2(
                jnp.clip(ir.margin / scale, 1.0, ir.delta_max)
            ).astype(dtype)
            dq = delta * ds.ds_round(res.rd_h, res.rd_l)
            dl = jnp.where(
                jnp.isfinite(l), delta * ds.ds_round(res.rl_h, res.rl_l), l
            )
            du = jnp.where(
                jnp.isfinite(u), delta * ds.ds_round(res.ru_h, res.ru_l), u
            )
            corr = admm.admm_solve(
                _ProxOps(ops, jnp.asarray(ir.prox, dtype)),
                dq, dl, du, work_cfg, scaling=scaling,
            )
            x_h2, x_l2 = ds.ds_add(x_h, x_l, corr.x / delta,
                                   jnp.zeros_like(corr.x))
            y_h2, y_lo2 = ds.ds_add(y_h, y_lo, corr.y / delta,
                                    jnp.zeros_like(corr.y))
            res2 = _residuals_dense(P, A, q, l, u, x_h2, x_l2, y_h2, cfg,
                                    y_l=y_lo2)
            return x_h2, x_l2, y_h2, y_lo2, res2, iters + corr.iters

        def skip(x_h, x_l, y_h, y_lo, res, iters):
            return x_h, x_l, y_h, y_lo, res, iters

        x_h, x_l, y_h, y_lo, res, iters = lax.cond(
            done, skip, do_round, x_h, x_l, y_h, y_lo, res, iters
        )

    x = ds.ds_round(x_h, x_l)
    y = ds.ds_round(y_h, y_lo)
    z = jnp.clip(ds.ds_round(*_ds_matvec_dense(A, x_h, x_l)), l, u)
    solved = (res.prim <= res.eps_prim) & (res.dual <= res.eps_dual)
    return admm.QPSolution(
        x=x, y=y, z=z, iters=iters, prim_res=res.prim, dual_res=res.dual,
        solved=solved,
        prim_infeasible=base.prim_infeasible,
        dual_infeasible=base.dual_infeasible,
    )


class _ProxOps:
    """Adds `sig * I` to the operator's quadratic term (P + sig I) by
    riding the sigma_vec argument, which every factorize/kkt_solve
    implementation already applies to ALL variable blocks. Composes under
    admm.ScaledOps: the inner call receives sigma_vec + cost_scale*sig, so
    the prox acts uniformly in the UNSCALED variable space."""

    def __init__(self, inner, sig):
        self.inner = inner
        self.sig = sig

    def matvec_P(self, x):
        return self.inner.matvec_P(x) + self.sig * x

    def matvec_A(self, x):
        return self.inner.matvec_A(x)

    def rmatvec_A(self, w):
        return self.inner.rmatvec_A(w)

    def row_inf_norms(self, D):
        return self.inner.row_inf_norms(D)

    def col_inf_norms(self, E):
        return self.inner.col_inf_norms(E)

    def col_inf_norms_P(self, D):
        return jnp.maximum(self.inner.col_inf_norms_P(D), self.sig * D)

    def factorize(self, rho_vec, sigma_vec, cost_scale=1.0):
        return self.inner.factorize(
            rho_vec, sigma_vec + cost_scale * self.sig, cost_scale
        )

    def kkt_solve(self, factor, rhs, rho_vec, sigma_vec, cost_scale=1.0):
        return self.inner.kkt_solve(
            factor, rhs, rho_vec, sigma_vec + cost_scale * self.sig,
            cost_scale,
        )


def solve_saa_qp_ir(
    st: SAAQPStatic,
    data,
    scp_iter,
    cfg: SolverConfig,
    ir: IRConfig = IRConfig(),
    x0=None,
    y0=None,
    ruiz_iters: int = 5,
) -> admm.QPSolution:
    """Structured ADMM + iterative refinement to cfg.eps_abs/eps_rel."""
    ops = SAAQPOps(st, data, scp_iter, kkt_refine_iters=cfg.kkt_refine_iters,
                   kkt_refine_mode=getattr(cfg, "kkt_refine_mode", "true"),
                   sweep_precision=getattr(cfg, "sweep_precision", "highest"),
                   kkt_chol_inverse=getattr(cfg, "kkt_chol_inverse", False))
    p_diag, q = build_objective(st, data)
    l, u = build_bounds(st, data, scp_iter)
    dtype = q.dtype
    scaling = admm.ruiz_equilibrate(ops, q, l, u, iters=ruiz_iters)

    import dataclasses

    work_cfg = dataclasses.replace(
        cfg, eps_abs=ir.work_eps, eps_rel=ir.work_eps, polish=False
    )
    base_cfg = dataclasses.replace(
        cfg,
        eps_abs=ir.base_eps_abs if ir.base_eps_abs is not None else ir.work_eps,
        eps_rel=ir.base_eps_rel if ir.base_eps_rel is not None else ir.work_eps,
        max_iter=(
            ir.base_max_iter if ir.base_max_iter is not None else cfg.max_iter
        ),
        polish=False,
    )
    base = admm.admm_solve(ops, q, l, u, base_cfg, x0=x0, y0=y0,
                           scaling=scaling)
    x_h, x_l = base.x, jnp.zeros_like(base.x)
    y = base.y
    iters = base.iters

    res = _residuals(ops, q, l, u, p_diag, x_h, x_l, y, cfg)

    for _ in range(ir.rounds):
        done = (res.prim <= res.eps_prim) & (res.dual <= res.eps_dual)

        def do_round(x_h, x_l, y, res, iters):
            scale = jnp.maximum(
                jnp.maximum(res.prim, res.dual), jnp.asarray(1e-30, dtype)
            )
            delta = _pow2(
                jnp.clip(ir.margin / scale, 1.0, ir.delta_max)
            ).astype(dtype)
            dq = delta * ds.ds_round(res.rd_h, res.rd_l)
            dl = jnp.where(
                jnp.isfinite(l), delta * ds.ds_round(res.rl_h, res.rl_l), l
            )
            du = jnp.where(
                jnp.isfinite(u), delta * ds.ds_round(res.ru_h, res.ru_l), u
            )
            corr = admm.admm_solve(
                _ProxOps(ops, jnp.asarray(ir.prox, dtype)),
                dq, dl, du, work_cfg, scaling=scaling,
            )
            x_h2, x_l2 = ds.ds_add(x_h, x_l, corr.x / delta,
                                   jnp.zeros_like(corr.x))
            y2 = y + corr.y / delta
            res2 = _residuals(ops, q, l, u, p_diag, x_h2, x_l2, y2, cfg)
            return x_h2, x_l2, y2, res2, iters + corr.iters

        def skip(x_h, x_l, y, res, iters):
            return x_h, x_l, y, res, iters

        x_h, x_l, y, res, iters = lax.cond(
            done, skip, do_round, x_h, x_l, y, res, iters
        )

    x = ds.ds_round(x_h, x_l)
    z = jnp.clip(ds.ds_round(*_ds_matvec_A(ops, x_h, x_l)), l, u)

    if cfg.polish:
        # Deterministic active-set vertex selection on top of the certified
        # point. On the degenerate post-gating QPs the certified-residual
        # solution SET still has macroscopic diameter; snapping to the
        # active-set vertex makes the selection a deterministic function of
        # the (now tightly resolved) active set, which stabilizes the SCP
        # fixed-point iteration against f32 linearization noise. The
        # polished point is accepted only if its COMPENSATED residuals
        # still certify at the target tolerance — honesty is preserved.
        xp, yp, zp = admm._polish(ops, q, l, u, x, y, z, cfg)
        resp = _residuals(
            ops, q, l, u, p_diag, xp, jnp.zeros_like(xp), yp, cfg
        )
        ok = (resp.prim <= resp.eps_prim) & (resp.dual <= resp.eps_dual)
        x = jnp.where(ok, xp, x)
        y = jnp.where(ok, yp, y)
        z = jnp.where(ok, zp, z)
        res = jax.tree.map(
            lambda a, b: jnp.where(ok, a, b), resp, res
        )

    solved = (res.prim <= res.eps_prim) & (res.dual <= res.eps_dual)
    return admm.QPSolution(
        x=x, y=y, z=z, iters=iters, prim_res=res.prim, dual_res=res.dual,
        solved=solved,
        prim_infeasible=base.prim_infeasible,
        dual_infeasible=base.dual_infeasible,
    )
