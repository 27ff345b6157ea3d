"""Double-single (two-float) compensated arithmetic: the f32-at-1e-8 path.

Without float64 units, the reference's tightest solver setting — OSQP at
eps_abs = eps_rel = 1e-8 for the car Gaussian baseline
(car/driving_gaussian.py:27) — is below what a plain f32 iterate can even
REPRESENT (relative roundoff ~6e-8). SURVEY.md section 7.3.1-2 calls for
compensated accumulation / f64 emulation where required; this module
provides it:

- error-free transformations (`two_sum`, Dekker `two_prod` — no fma
  assumed, valid for IEEE binary32 and binary64),
- a compensated dense matvec whose result is a (hi, lo) pair accurate to
  ~eps^2 ≈ 1e-14 relative in f32,
- `refine_kkt_ds`: iterative refinement of an equality-constrained KKT
  system with an f32 LU factorization and double-single residuals, the
  solution held as a (hi, lo) pair,
- `solve_dense_qp_ds`: f32 ADMM+polish to identify the active set, then
  DS-refined active-set KKT solve — achieving true (f64-verified) KKT
  residuals at the reference's 1e-8 tolerance from f32-only arithmetic
  (tests/test_ds.py runs the actual car-Gaussian subproblem in f32).

All functions are dtype-generic; in f64 they give ~1e-30-class residuals
(quad-double-single), but the intended use is f32-only arithmetic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# Dekker splitting constant: 2^ceil(p/2) + 1 with p the significand bits
_SPLIT = {jnp.dtype(jnp.float32): 4097.0, jnp.dtype(jnp.float64): 134217729.0}


# =========================================================================
# EAGER-ONLY: do NOT wrap these functions in jax.jit / scan / fori_loop.
#
# XLA codegen contracts mul-followed-by-add chains into FMA (verified on
# XLA:CPU: jit(a*b + c) differs from round(a*b) + c on 23% of random f32
# triples; neither optimization_barrier, bitcast laundering,
# --xla_cpu_enable_fast_math=false nor --xla_allow_excess_precision=false
# prevents it). FMA changes the rounding the error-free transforms depend
# on, silently zeroing the compensation terms. Eager per-op dispatch keeps
# every add/mul a separate XLA computation, where contraction cannot occur
# — the accuracy tests in tests/test_ds.py run eagerly for this reason.
# The optimization_barriers below are defense-in-depth against HLO-level
# algebraic rewrites if a caller jits anyway; they do NOT stop the FMA
# contraction, so jitting remains unsupported.
# =========================================================================
_ob = lax.optimization_barrier


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth)."""
    s = _ob(a + b)
    bb = _ob(s - a)
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    c = _ob(jnp.asarray(_SPLIT[jnp.dtype(a.dtype)], a.dtype) * a)
    hi = _ob(c - (c - a))
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b = p + e (Dekker, no fma)."""
    p = _ob(a * b)
    a1, a2 = _split(a)
    b1, b2 = _split(b)
    e = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, e


def ds_add(hi1, lo1, hi2, lo2):
    """(hi1, lo1) + (hi2, lo2), renormalized."""
    s, e = two_sum(hi1, hi2)
    e = e + (lo1 + lo2)
    return two_sum(s, e)


def ds_matvec(A, x_hi, x_lo):
    """Compensated A @ x for a DS vector x: returns (hi, lo) per row.

    All m*n products are formed in one error-free two_prod over the full
    matrix, then accumulated column-by-column with error-free sums (an
    eager Python loop — see the module banner: scan/jit would let XLA
    contract the mul+add chains into FMA and break the compensation). The
    result is accurate to ~eps^2 relative before the final rounding."""
    m, n = A.shape
    P, Pe = two_prod(A, x_hi[None, :])
    Pe = Pe + A * x_lo[None, :]
    acc_hi = jnp.zeros(m, A.dtype)
    acc_lo = jnp.zeros(m, A.dtype)
    for j in range(n):
        acc_hi, e = two_sum(acc_hi, P[:, j])
        acc_lo = acc_lo + (e + Pe[:, j])
    return two_sum(acc_hi, acc_lo)


def pow2_equilibrate(K, iters: int = 4):
    """Symmetric diagonal scaling D (powers of two, hence EXACT to apply in
    floating point) bringing the rows/cols of D K D toward unit inf-norm —
    pulls kappa below the 1/eps_f32 contraction threshold for the f32
    refinement without perturbing a single bit of the scaled entries."""
    Kn = np.asarray(K, np.float64)
    d = np.ones(Kn.shape[0])
    for _ in range(iters):
        r = np.abs(np.diag(d) @ Kn @ np.diag(d)).max(axis=1)
        r = np.where(r > 0, r, 1.0)
        d = d * np.exp2(np.round(-0.5 * np.log2(r)))
    return jnp.asarray(d, K.dtype)


def refine_kkt_ds(K_factor, rhs, K_target=None, num_iters: int = 25):
    """Solve K_target s = rhs with an f32 LU factorization of K_factor
    (a regularized preconditioner) and double-single iterative refinement;
    the iterate is a DS pair.

    Residuals are measured against K_target (default: K_factor), so a
    delta-regularized factorization still converges to the UNregularized
    solution — the contraction factor is ~kappa(K_target)*(eps + delta)
    and the attainable residual is limited only by the compensated-residual
    precision (~1e-14 relative in f32)."""
    dtype = K_factor.dtype
    K_target = K_factor if K_target is None else K_target
    lu, piv = jax.scipy.linalg.lu_factor(K_factor)
    x_hi = jax.scipy.linalg.lu_solve((lu, piv), rhs)
    x_lo = jnp.zeros_like(x_hi)

    # eager Python loop (see module banner)
    for _ in range(num_iters):
        Kx_hi, Kx_lo = ds_matvec(K_target, x_hi, x_lo)
        # r = rhs - K_target x in DS
        r_hi, r_e = two_sum(rhs, -Kx_hi)
        r = r_hi + (r_e - Kx_lo)
        d = jax.scipy.linalg.lu_solve((lu, piv), r.astype(dtype))
        x_hi, x_lo = ds_add(x_hi, x_lo, d, jnp.zeros_like(d))

    return x_hi, x_lo


def kkt_residuals_ds(P, q, A_act, b_act, x_hi, x_lo, y_act_hi, y_act_lo):
    """Compensated unscaled KKT residuals of an active-set solution:
    dual = P x + q + A_act^T y, prim = A_act x - b_act (both DS-evaluated,
    returned as f32 of the hi parts)."""
    Px_hi, Px_lo = ds_matvec(P, x_hi, x_lo)
    Aty_hi, Aty_lo = ds_matvec(A_act.T, y_act_hi, y_act_lo)
    d_hi, d_e = two_sum(Px_hi, Aty_hi)
    dual_hi, dual_e = two_sum(d_hi, q)
    dual = dual_hi + (dual_e + d_e + Px_lo + Aty_lo)
    Ax_hi, Ax_lo = ds_matvec(A_act, x_hi, x_lo)
    p_hi, p_e = two_sum(Ax_hi, -b_act)
    prim = p_hi + (p_e + Ax_lo)
    return prim, dual


def solve_dense_qp_ds(P, q, A, l, u, cfg=None, refine_iters: int = 25):
    """f32-only dense QP solve to 1e-8-class true residuals.

    1. OSQP-semantics f32 ADMM with polish identifies the active set.
    2. The active-set KKT system [[P + dI, A_a^T], [A_a, -dI]] is factored
       in f32 and DS-refined; x and the active duals are DS pairs.

    Runs eagerly (the active set is data-dependent); intended for the
    small dense QPs of the Gaussian baselines (car/driving_gaussian.py:27
    eps 1e-8 is the stress case). Returns (x_hi, x_lo, y, info dict).
    """
    from riskaversetrajopt_tpu.core.config import SolverConfig
    from riskaversetrajopt_tpu.ops import admm

    dtype = P.dtype
    cfg = cfg or SolverConfig(eps_abs=1e-6, eps_rel=1e-6, max_iter=100000)
    sol = admm.solve_dense_qp(P, q, A, l, u, cfg)
    y = np.asarray(sol.y)
    z = np.asarray(sol.z)
    l_np, u_np = np.asarray(l), np.asarray(u)
    z_tol = np.sqrt(np.finfo(np.asarray(z).dtype).eps) * max(
        1.0, np.abs(z).max()
    )
    low = ((y < -1e-12) | (z - l_np < z_tol)) & np.isfinite(l_np)
    upp = ((y > 1e-12) | (u_np - z < z_tol)) & np.isfinite(u_np)
    eq = np.isfinite(l_np) & np.isfinite(u_np) & (u_np - l_np < 1e-12)
    A_np = np.asarray(A, np.float32)
    n = P.shape[0]
    m = A.shape[0]
    delta = jnp.asarray(1e-7, dtype)
    import scipy.linalg as _sla

    def prune_ordered(act_list):
        """Maximal independent row subset via f32 QR in the GIVEN order
        (newest rows first): degenerate active sets (duplicated box rows,
        the sum-alpha row atop the individual alpha bounds, ...) make the
        KKT numerically singular (kappa ~ 1e19 observed on the
        car-Gaussian subproblem), and a dependency must evict the OLD row
        — pivoted QR would keep whichever has the larger norm and can
        evict the row just added, cycling forever. Selection is
        combinatorial, so f32 rank detection suffices."""
        if not act_list:
            return []
        idx = np.asarray(act_list)
        At = A_np[idx].T.astype(np.float32)
        _, R = _sla.qr(At, mode="economic")
        diag = np.abs(np.diag(R))
        thresh = (diag.max() if diag.size else 1.0) * np.sqrt(
            np.finfo(np.float32).eps
        )
        return [act_list[k] for k in range(diag.size) if diag[k] > thresh]

    def kkt_solve(act, at_lower):
        b_act = jnp.asarray(np.where(at_lower, l_np, u_np)[act], dtype)
        A_act = jnp.asarray(A_np[act], dtype)
        na = int(act.sum())
        K0 = jnp.zeros((n + na, n + na), dtype)
        K0 = K0.at[:n, :n].set(jnp.asarray(P, dtype))
        K0 = K0.at[:n, n:].set(A_act.T)
        K0 = K0.at[n:, :n].set(A_act)
        # power-of-two equilibration: exact to apply, restores the f32
        # refinement contraction on ill-conditioned KKT systems (the car
        # Gaussian's quantile-backoff rows span orders of magnitude)
        d_sc = pow2_equilibrate(K0)
        K0_s = d_sc[:, None] * K0 * d_sc[None, :]
        K_s = K0_s + delta * jnp.diag(
            d_sc
            * d_sc
            * jnp.concatenate([jnp.ones(n, dtype), -jnp.ones(na, dtype)])
        )
        rhs_s = d_sc * jnp.concatenate([-jnp.asarray(q, dtype), b_act])
        y_hi, y_lo = refine_kkt_ds(K_s, rhs_s, K_target=K0_s,
                                   num_iters=refine_iters)
        s_hi, s_lo = d_sc * y_hi, d_sc * y_lo  # unscale exactly
        return s_hi[:n], s_lo[:n], s_hi[n:], s_lo[n:], A_act, b_act

    # active-set refinement: the f32 ADMM's active-set guess can
    # over/under-select (its iterate stalls near the f32 residual floor).
    # Schedule: add the WORST violated row (one at a time, newest-first in
    # the pruning order so a dependency evicts an old row, not the new
    # one); once feasible, drop wrong-sign duals one at a time. Each pass
    # is one exact (DS-refined) KKT solve.
    at_lower = low & ~eq
    act_list = list(np.flatnonzero(eq)) + [
        int(i) for i in np.flatnonzero((low | upp) & ~eq)
    ]
    act_list = prune_ordered(act_list)
    tol_u = 1e-9 * (1.0 + np.abs(np.where(np.isfinite(u_np), u_np, 0.0)))
    tol_l = 1e-9 * (1.0 + np.abs(np.where(np.isfinite(l_np), l_np, 0.0)))
    for _ in range(80):
        act = np.zeros(m, bool)
        act[np.asarray(act_list, int)] = True
        x_hi, x_lo, ya_hi, ya_lo, A_act, b_act = kkt_solve(act, at_lower)
        x_f64 = np.asarray(x_hi, np.float64) + np.asarray(x_lo, np.float64)
        Ax = A_np.astype(np.float64) @ x_f64
        # per-row tolerances: a global max|Ax| scale (rows span orders of
        # magnitude here) would let 1e-5-level violations through
        excess_u = np.where(~act, Ax - (u_np + tol_u), -np.inf)
        excess_l = np.where(~act, (l_np - tol_l) - Ax, -np.inf)
        worst = int(np.argmax(np.maximum(excess_u, excess_l)))
        if max(excess_u[worst], excess_l[worst]) > 0:
            at_lower[worst] = excess_l[worst] >= excess_u[worst]
            act_list = prune_ordered([worst] + act_list)
            continue
        ya = np.asarray(ya_hi, np.float64)
        # act rows are ordered by np.flatnonzero (sorted), map back
        act_idx = np.flatnonzero(act)
        y_tol = 1e-9 * (1.0 + np.abs(ya))
        sign_err = np.zeros(act_idx.size)
        for k, row in enumerate(act_idx):
            if eq[row]:
                continue
            if at_lower[row]:
                sign_err[k] = max(0.0, ya[k] - y_tol[k])
            else:
                sign_err[k] = max(0.0, -ya[k] - y_tol[k])
        if sign_err.size and sign_err.max() > 0:
            drop = int(act_idx[int(np.argmax(sign_err))])
            act_list = [r for r in act_list if r != drop]
            continue
        break
    act = np.zeros(m, bool)
    act[np.asarray(act_list, int)] = True

    prim, dual = kkt_residuals_ds(
        jnp.asarray(P, dtype), jnp.asarray(q, dtype), A_act, b_act,
        x_hi, x_lo, ya_hi, ya_lo,
    )
    # export duals as hi+lo (the DS pair is the computed object; collapsing
    # to a single f32 would re-round and cost ~eps*|y| dual accuracy)
    y_full = np.zeros(m, np.float64)
    y_full[act] = np.asarray(ya_hi, np.float64) + np.asarray(
        ya_lo, np.float64
    )
    info = {
        "active": act,
        "prim_res": float(np.abs(np.asarray(prim)).max()) if act.any() else 0.0,
        "dual_res": float(np.abs(np.asarray(dual)).max()),
        "admm_iters": int(sol.iters),
    }
    return x_hi, x_lo, jnp.asarray(y_full), info
