"""Double-single (compensated-f32) ADMM for the structured SAA QP: the
f32-only high-precision solver leg that tracks the reference's x64 branch.

WHY. The post-gating SCP subproblems have degenerate optimal faces: which
point of the optimal set a solver returns is decided by its iterate PATH,
not by the termination tolerance (PARITY.md "trajectory reproducibility").
Two independent x64 ADMM engines land within ~2e-4 of each other; plain
f32 iterates inject ~6e-8 noise per iteration and land on macroscopically
different face points (l2 vs golden 0.03-0.3), which no amount of residual
certification (ops/qp_refine.py) can undo after the fact. The reference
sidesteps all of this by running OSQP in f64 on CPU (drone_risk.py:13-18);
this backend was written for an accelerator without f64 units.

HOW. This module runs the SAME OSQP-semantics ADMM iteration as
ops/admm.py, but with the iterate triple (x, z, y) carried as
double-single pairs (ops/dsjit.py: FMA-immune, jit-safe compensated f32,
~1e-14-relative per operation — between f32's 6e-8 and f64's 1.1e-16):

  - the two per-iteration Jacobian sweeps (rmatvec for the KKT rhs,
    matvec for the z-update) run compensated end-to-end
    (qp_refine._ds_matvec_A/_ds_rmatvec_A, Ruiz scaling applied as exact
    ds rescalings);
  - the KKT solve keeps the f32 Schur factorization (ops/saa_qp.py) as a
    preconditioner and refines against the compensated TRUE residual
    (`ds_kkt_passes` rounds, each contracting by ~cond(S)*eps_f32);
  - over-relaxation, clipping, and dual updates are elementwise ds;
    the relaxation constant alpha and (1 - alpha) are carried as ds
    pairs of their f64 values so the fixed-point map matches the x64
    map to ~1e-16, not to f32's 1e-8;
  - termination residuals (unscaled, OSQP criterion) and the adaptive-rho
    ratio are evaluated in ds, so `solved` is honest at eps 1e-6 — below
    the plain-f32 stall floor of ~1e-5.

Remaining divergence sources vs the x64 path are the f32 problem DATA
(G, bounds from the f32 define phase, ~1e-7 relative) and the f32 Ruiz/rho
scalars — structural perturbations of the same class as switching QP
engines, which the branch is measured to tolerate (PARITY.md: independent
engines agree to 2e-4 at M=1000).

Cost: 2 ds Jacobian sweeps per iteration + 2 per ds KKT pass; each ds
sweep is ~6-9x the memory traffic of its f32 counterpart (exact-product
splitting + pairwise compensated reduction). This is the parity leg, not
the speed leg.

Reference parity target: the SCP golden-trajectory contract at
drone/drone_risk.py:495-540 (BASELINE.md north star, <=1e-3 relative L2),
asserted on the x64 path in CI and by this backend in true f32.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from riskaversetrajopt_tpu.core.config import SolverConfig
from riskaversetrajopt_tpu.ops import admm
from riskaversetrajopt_tpu.ops import dsjit as ds
from riskaversetrajopt_tpu.ops.qp_refine import _ds_matvec_A, _ds_rmatvec_A
from riskaversetrajopt_tpu.ops.saa_qp import (
    SAAQPOps,
    SAAQPStatic,
    build_bounds,
    build_objective,
)

_RHO_MIN = 1e-6
_RHO_MAX = 1e6


def _ds_const(v, dtype):
    """ds pair of the f64 value of a config constant (so map constants
    match the x64 iteration map to ~1e-16, not to f32 rounding)."""
    v64 = np.float64(v)
    h = np.asarray(v64, dtype)
    lo = np.asarray(v64 - np.float64(h), dtype)
    return jnp.asarray(h), jnp.asarray(lo)


class _DSScaledOps:
    """Compensated scaled-space operator views: Abar = E A D, Pbar = c D P D.

    All methods take and return ds pairs; D/E/c are the exact f32 Ruiz
    scalings (applying them as ds rescalings keeps the scaled problem an
    EXACT rescaling of the f32 problem data)."""

    def __init__(self, ops: SAAQPOps, scaling: admm.Scaling):
        self.ops = ops
        self.s = scaling

    def matvec_A(self, xh, xl):
        s = self.s
        th, tl = ds.ds_scale(xh, xl, s.D)
        rh, rl = _ds_matvec_A(self.ops, th, tl)
        return ds.ds_scale(rh, rl, s.E)

    def rmatvec_A(self, wh, wl):
        s = self.s
        th, tl = ds.ds_scale(wh, wl, s.E)
        rh, rl = _ds_rmatvec_A(self.ops, th, tl)
        return ds.ds_scale(rh, rl, s.D)

    def matvec_P(self, xh, xl):
        # c * D * p_diag * D * x, chained so every factor stays exact
        s = self.s
        th, tl = ds.ds_scale(xh, xl, s.D)
        th, tl = ds.ds_scale(th, tl, self.ops.p_diag)
        th, tl = ds.ds_scale(th, tl, s.D)
        return ds.ds_scale(th, tl, s.c)


def _ds_bounds(b, scale):
    """ds pair of scale*b with +/-inf rows passed through exactly."""
    fin = jnp.isfinite(b)
    h, lo = ds.two_prod(jnp.where(fin, b, 0.0), scale)
    return jnp.where(fin, h, b), jnp.where(fin, lo, 0.0)


def _ds_clip(ah, al, lh, ll, uh, ul):
    """clip((ah, al), (lh, ll), (uh, ul)) with lexicographic ds compare.

    The pairs are normalized (h = fl(h + l)), so h-then-l lexicographic
    comparison decides the true ordering up to ~eps^2 — the same decision
    noise class as the x64 path's own eps64 comparisons."""
    below = (ah < lh) | ((ah == lh) & (al < ll))
    above = (ah > uh) | ((ah == uh) & (al > ul))
    h = jnp.where(below, lh, jnp.where(above, uh, ah))
    lo = jnp.where(below, ll, jnp.where(above, ul, al))
    return h, lo


class _DSState(NamedTuple):
    xh: jnp.ndarray
    xl: jnp.ndarray
    zh: jnp.ndarray
    zl: jnp.ndarray
    yh: jnp.ndarray
    yl: jnp.ndarray
    rho: jnp.ndarray
    it: jnp.ndarray
    prim_res: jnp.ndarray
    dual_res: jnp.ndarray
    done: jnp.ndarray
    refactor: jnp.ndarray
    rho_next: jnp.ndarray


def solve_saa_qp_ds(
    st: SAAQPStatic,
    data,
    scp_iter,
    cfg: SolverConfig,
    x0=None,
    y0=None,
    rho0=None,
    ruiz_iters: int = 5,
    ds_kkt_passes: int = 1,
) -> admm.QPSolution:
    """OSQP-semantics ADMM with double-single iterates (module docstring)."""
    ops = SAAQPOps(
        st, data, scp_iter,
        kkt_refine_iters=max(1, cfg.kkt_refine_iters),
        kkt_refine_mode="factored",
        sweep_precision="highest",
        kkt_chol_inverse=getattr(cfg, "kkt_chol_inverse", False),
    )
    p_diag, q = build_objective(st, data)
    l, u = build_bounds(st, data, scp_iter)
    dtype = q.dtype
    n = q.shape[0]
    m = l.shape[0]

    scaling = admm.ruiz_equilibrate(ops, q, l, u, iters=ruiz_iters)
    D, E, c = scaling.D, scaling.E, scaling.c
    sops = admm.ScaledOps(ops, scaling)  # f32 KKT preconditioner path
    dops = _DSScaledOps(ops, scaling)

    # scaled data as exact ds rescalings of the f32 problem
    qs_h, qs_l = ds.two_prod(q, D)
    qs_h, qs_l = ds.ds_scale(qs_h, qs_l, c)
    ls_h, ls_l = _ds_bounds(l, E)
    us_h, us_l = _ds_bounds(u, E)
    ls_f, us_f = ls_h, us_h  # rounded bounds for rho-row classification

    sigma_vec = jnp.full(n, cfg.sigma, dtype)
    a_h, a_l = _ds_const(cfg.alpha_relax, dtype)
    oma_h, oma_l = _ds_const(1.0 - np.float64(cfg.alpha_relax), dtype)
    rho0 = jnp.asarray(cfg.rho if rho0 is None else rho0, dtype)
    rho0 = jnp.clip(rho0, _RHO_MIN, _RHO_MAX)
    _ruf = float(getattr(cfg, "rho_update_factor", 5.0))
    q_norm_unscaled = jnp.max(jnp.abs(q))

    # scaled warm start: x = x0 / D, y = y0 * c / E (ds divisions/products)
    if x0 is None:
        xh = jnp.zeros(n, dtype)
        xl = jnp.zeros(n, dtype)
    else:
        xh, xl = ds.ds_div(x0.astype(dtype), jnp.zeros(n, dtype), D)
    if y0 is None:
        yh = jnp.zeros(m, dtype)
        yl = jnp.zeros(m, dtype)
    else:
        yh, yl = ds.two_prod(y0.astype(dtype), c)
        yh, yl = ds.ds_div(yh, yl, E)
    az_h, az_l = dops.matvec_A(xh, xl)
    zh, zl = _ds_clip(az_h, az_l, ls_h, ls_l, us_h, us_l)

    def kkt_solve_ds(factor, rv, rh, rl):
        """f32 factor solve + `ds_kkt_passes` compensated-true-residual
        refinement rounds: K = Pbar + diag(sigma) + Abar^T R Abar."""
        xt_h = sops.kkt_solve(factor, rh + rl, rv, sigma_vec)
        xt = (xt_h, jnp.zeros_like(xt_h))
        for _ in range(ds_kkt_passes):
            ph, pl = dops.matvec_P(*xt)
            ah, al = dops.matvec_A(*xt)
            ah, al = ds.ds_scale(ah, al, rv)
            bh, bl = dops.rmatvec_A(ah, al)
            th, tl = ds.ds_add(ph, pl, bh, bl)
            sh, sl = ds.ds_scale(xt[0], xt[1], sigma_vec)
            th, tl = ds.ds_add(th, tl, sh, sl)
            res_h, res_l = ds.ds_add(rh, rl, -th, -tl)
            dx = sops.kkt_solve(factor, res_h + res_l, rv, sigma_vec)
            xt = ds.ds_add(xt[0], xt[1], dx, jnp.zeros_like(dx))
        return xt

    def one_iter(xh, xl, zh, zl, yh, yl, rv, factor):
        # rhs = sigma*x - qs + Abar^T (rv*z - y)
        wh, wl = ds.ds_scale(zh, zl, rv)
        wh, wl = ds.ds_add(wh, wl, -yh, -yl)
        rh, rl = dops.rmatvec_A(wh, wl)
        sh, sl = ds.ds_scale(xh, xl, sigma_vec)
        rh, rl = ds.ds_add(rh, rl, sh, sl)
        rh, rl = ds.ds_add(rh, rl, -qs_h, -qs_l)
        xt_h, xt_l = kkt_solve_ds(factor, rv, rh, rl)
        zt_h, zt_l = dops.matvec_A(xt_h, xt_l)
        # x_next = alpha*xt + (1-alpha)*x (alpha as ds of its f64 value)
        ax_h, ax_l = ds.ds_mul(xt_h, xt_l, a_h, a_l)
        ox_h, ox_l = ds.ds_mul(xh, xl, oma_h, oma_l)
        xn_h, xn_l = ds.ds_add(ax_h, ax_l, ox_h, ox_l)
        # z_relax = alpha*zt + (1-alpha)*z
        az_h, az_l = ds.ds_mul(zt_h, zt_l, a_h, a_l)
        oz_h, oz_l = ds.ds_mul(zh, zl, oma_h, oma_l)
        zr_h, zr_l = ds.ds_add(az_h, az_l, oz_h, oz_l)
        # z_next = clip(z_relax + y/rv, ls, us)
        yr_h, yr_l = ds.ds_div(yh, yl, rv)
        arg_h, arg_l = ds.ds_add(zr_h, zr_l, yr_h, yr_l)
        zn_h, zn_l = _ds_clip(arg_h, arg_l, ls_h, ls_l, us_h, us_l)
        # y_next = y + rv*(z_relax - z_next)
        dh, dl = ds.ds_add(zr_h, zr_l, -zn_h, -zn_l)
        dh, dl = ds.ds_scale(dh, dl, rv)
        yn_h, yn_l = ds.ds_add(yh, yl, dh, dl)
        return xn_h, xn_l, zn_h, zn_l, yn_h, yn_l

    def residuals(xh, xl, zh, zl, yh, yl):
        """Unscaled OSQP residuals + eps thresholds + scaled rho ratio,
        all evaluated in ds (mirrors ops/admm.residuals)."""
        Axs = dops.matvec_A(xh, xl)
        Pxs = dops.matvec_P(xh, xl)
        Atys = dops.rmatvec_A(yh, yl)
        Ax = ds.ds_div(*Axs, E)
        zu = ds.ds_div(zh, zl, E)
        Px = ds.ds_div(*ds.ds_div(*Pxs, D), c)
        Aty = ds.ds_div(*ds.ds_div(*Atys, D), c)
        prim = jnp.max(jnp.abs(ds.ds_round(*ds.ds_add(*Ax, -zu[0], -zu[1]))))
        dh, dl = ds.ds_add(*Px, *Aty)
        dh, dl = ds.ds_add(dh, dl, q, jnp.zeros_like(q))
        dual = jnp.max(jnp.abs(ds.ds_round(dh, dl)))
        eps_prim = cfg.eps_abs + cfg.eps_rel * jnp.maximum(
            jnp.max(jnp.abs(ds.ds_round(*Ax))),
            jnp.max(jnp.abs(ds.ds_round(*zu))),
        )
        eps_dual = cfg.eps_abs + cfg.eps_rel * jnp.maximum(
            jnp.maximum(
                jnp.max(jnp.abs(ds.ds_round(*Px))),
                jnp.max(jnp.abs(ds.ds_round(*Aty))),
            ),
            q_norm_unscaled,
        )
        # adaptive-rho ratio on scaled residuals (OSQP sec 5.2)
        prim_s = jnp.max(jnp.abs(
            ds.ds_round(*ds.ds_add(Axs[0], Axs[1], -zh, -zl))
        ))
        ds_h, ds_l = ds.ds_add(Pxs[0], Pxs[1], qs_h, qs_l)
        ds_h, ds_l = ds.ds_add(ds_h, ds_l, Atys[0], Atys[1])
        dual_s = jnp.max(jnp.abs(ds.ds_round(ds_h, ds_l)))
        denom_p = jnp.maximum(
            jnp.max(jnp.abs(Axs[0])), jnp.max(jnp.abs(zh))
        ) + 1e-30
        denom_d = jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Pxs[0])), jnp.max(jnp.abs(Atys[0]))),
            jnp.max(jnp.abs(qs_h)),
        ) + 1e-30
        ratio = (prim_s / denom_p) / (dual_s / denom_d + 1e-30)
        return prim, dual, eps_prim, eps_dual, ratio

    check = int(cfg.check_every)

    def make_body(factor):
        def body(s: _DSState):
            rv = admm.rho_vector(ls_f, us_f, s.rho)

            def inner(j, xs):
                return one_iter(*xs, rv, factor)

            xh, xl, zh, zl, yh, yl = lax.fori_loop(
                0, check, inner, (s.xh, s.xl, s.zh, s.zl, s.yh, s.yl)
            )
            prim, dual, eps_prim, eps_dual, ratio = residuals(
                xh, xl, zh, zl, yh, yl
            )
            solved = (prim <= eps_prim) & (dual <= eps_dual)
            if cfg.adaptive_rho:
                rho_new = jnp.clip(
                    s.rho * jnp.sqrt(ratio), _RHO_MIN, _RHO_MAX
                )
                refactor = (
                    ((rho_new > _ruf * s.rho) | (rho_new < s.rho / _ruf))
                    & jnp.logical_not(solved)
                )
            else:
                rho_new = s.rho
                refactor = jnp.asarray(False)
            return _DSState(
                xh=xh, xl=xl, zh=zh, zl=zl, yh=yh, yl=yl,
                rho=s.rho, it=s.it + check,
                prim_res=prim, dual_res=dual, done=solved,
                refactor=refactor, rho_next=rho_new,
            )

        return body

    def inner_cond(s: _DSState):
        return (
            jnp.logical_not(s.done)
            & jnp.logical_not(s.refactor)
            & (s.it < cfg.max_iter)
        )

    init = _DSState(
        xh=xh, xl=xl, zh=zh, zl=zl, yh=yh, yl=yl,
        rho=rho0, it=jnp.zeros((), jnp.int32),
        prim_res=jnp.asarray(jnp.inf, dtype),
        dual_res=jnp.asarray(jnp.inf, dtype),
        done=jnp.asarray(False),
        refactor=jnp.asarray(False),
        rho_next=rho0,
    )
    factor0 = sops.factorize(admm.rho_vector(ls_f, us_f, rho0), sigma_vec)

    if cfg.adaptive_rho:
        # two-level epoch loop as in ops/admm.admm_solve: refactorization
        # stays OUT of the hot while body (a cond-gated factorize inside
        # the iterating body doubles per-iteration cost on this toolchain)
        def outer_cond(carry):
            s, _ = carry
            return jnp.logical_not(s.done) & (s.it < cfg.max_iter)

        def outer_body(carry):
            s, factor = carry
            s = lax.while_loop(inner_cond, make_body(factor), s)
            rho2 = jnp.where(s.refactor, s.rho_next, s.rho)
            factor2 = sops.factorize(
                admm.rho_vector(ls_f, us_f, rho2), sigma_vec
            )
            return (s._replace(rho=rho2, refactor=jnp.asarray(False)), factor2)

        s, _ = lax.while_loop(outer_cond, outer_body, (init, factor0))
    else:
        s = lax.while_loop(inner_cond, make_body(factor0), init)

    # unscale (ds) and round
    xu = ds.ds_round(*ds.ds_scale(s.xh, s.xl, D))
    yu_h, yu_l = ds.ds_scale(s.yh, s.yl, E)
    yu = ds.ds_round(*ds.ds_div(yu_h, yu_l, c))
    zu = ds.ds_round(*ds.ds_div(s.zh, s.zl, E))

    return admm.QPSolution(
        x=xu, y=yu, z=zu, iters=s.it,
        prim_res=s.prim_res, dual_res=s.dual_res, solved=s.done,
        prim_infeasible=jnp.asarray(False), dual_infeasible=jnp.asarray(False),
        rho=s.rho,
    )
