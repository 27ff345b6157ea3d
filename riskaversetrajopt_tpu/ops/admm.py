"""On-chip ADMM QP solver with OSQP-equivalent semantics.

Replaces the reference's native OSQP dependency (C solver called at every SCP
iteration through a Python<->C boundary, car/driving.py:430-440,
drone/drone_risk.py:433-452) with a fully jitted fixed-point loop so the whole
SCP iteration — define + solve — is one XLA computation.

Problem form (OSQP form):
    minimize    (1/2) x^T P x + q^T x
    subject to  l <= A x <= u

Algorithm (OSQP, Stellato et al. 2020):
  - modified Ruiz equilibration (matrix-free: operators expose structural
    row/column infinity norms, so the big per-sample Jacobian stack is never
    materialized as a matrix),
  - per-row penalties rho: rho on inequality rows, 1e3*rho on equality rows,
    1e-6 on fully-loose rows, with adaptive rescaling at termination checks,
  - over-relaxed iterates (alpha = 1.6),
  - unscaled-residual termination:
      ||Ax - z||_inf         <= eps_abs + eps_rel * max(||Ax||, ||z||)
      ||Px + q + A^T y||_inf <= eps_abs + eps_rel * max(||Px||,||A^T y||,||q||)
  - optional active-set polishing.

The core is parameterized by an operator object so the same loop drives the
dense instantiation below and the structured sample-sharded SAA instantiation
(ops/saa_qp.py), whose matvecs are batched einsums over per-sample constraint
blocks with psum-able couplings.

Operator interface (all jit-traceable):
    matvec_P(x) -> (n,)
    matvec_A(x) -> (m,)
    rmatvec_A(w) -> (n,)
    factorize(rho_vec, sigma_vec, cost_scale) -> factor
    kkt_solve(factor, rhs, rho_vec, sigma_vec, cost_scale) -> x
        solves (cost_scale*P + diag(sigma_vec) + A^T diag(rho_vec) A) x = rhs
    row_inf_norms(D) -> (m,)   max_j |A_ij| * D_j      (for Ruiz)
    col_inf_norms(E) -> (n,)   max_i E_i * |A_ij|      (for Ruiz)
    col_inf_norms_P(D) -> (n,) max_i D_i * |P_ij|      (for Ruiz cost scaling)
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from riskaversetrajopt_tpu.core.config import SolverConfig

_RHO_MIN = 1e-6
_RHO_MAX = 1e6
_LOOSE_RHO = 1e-6
_EQ_TOL = 1e-9
_MIN_SCALING = 1e-4
_MAX_SCALING = 1e4


class QPSolution(NamedTuple):
    x: jnp.ndarray  # primal solution (n,)
    y: jnp.ndarray  # dual solution (m,)
    z: jnp.ndarray  # projected constraint values (m,)
    iters: jnp.ndarray  # iterations taken (scalar int)
    prim_res: jnp.ndarray
    dual_res: jnp.ndarray
    solved: jnp.ndarray  # bool
    # OSQP-style infeasibility certificates (False when not computed)
    prim_infeasible: jnp.ndarray = jnp.asarray(False)
    dual_infeasible: jnp.ndarray = jnp.asarray(False)
    # final adapted rho (0.0 when the backend does not track it) — OSQP
    # keeps rho in its workspace across update()/solve() calls, so in the
    # reference's setup-once-then-update SCP loop (drone_risk.py:425-452)
    # each solve starts from the previously adapted rho; callers thread
    # this back in as rho0 to reproduce that warm-start behavior
    rho: jnp.ndarray = jnp.asarray(0.0)


class Scaling(NamedTuple):
    """Ruiz equilibration scalings: x = D xbar, constraint rows scaled by E,
    cost scaled by c."""

    D: jnp.ndarray  # (n,)
    E: jnp.ndarray  # (m,)
    c: jnp.ndarray  # scalar


def ruiz_equilibrate(ops, q, l, u, iters: int = 5) -> Scaling:
    """Modified Ruiz equilibration (OSQP sec 5.1), matrix-free.

    Iteratively scales rows/cols of [[P, A^T], [A, 0]] toward unit infinity
    norm, then normalizes the cost. Only structural norm callbacks are used."""
    n = q.shape[0]
    m = l.shape[0]
    dtype = q.dtype
    D = jnp.ones(n, dtype)
    E = jnp.ones(m, dtype)
    c = jnp.ones((), dtype)

    def body(_, DEc):
        D, E, c = DEc
        # column norms of the scaled KKT block for primal variables:
        # max( c * D_j * max_i D_i |P_ij|, max_i E_i |A_ij| D_j )
        colP = c * D * ops.col_inf_norms_P(D)
        colA = ops.col_inf_norms(E) * D
        col = jnp.maximum(colP, colA)
        rowA = ops.row_inf_norms(D) * E
        d_new = 1.0 / jnp.sqrt(jnp.clip(col, _MIN_SCALING, _MAX_SCALING))
        e_new = 1.0 / jnp.sqrt(jnp.clip(rowA, _MIN_SCALING, _MAX_SCALING))
        D = D * d_new
        E = E * e_new
        # cost normalization
        colP_new = c * D * ops.col_inf_norms_P(D)
        gamma_denom = jnp.maximum(jnp.mean(colP_new), jnp.max(jnp.abs(c * D * q)))
        gamma = 1.0 / jnp.clip(gamma_denom, _MIN_SCALING, _MAX_SCALING)
        # bound the accumulated cost scaling: with a fully degenerate
        # objective (P = 0, q = 0) gamma compounds every sweep and an
        # unbounded c crushes the dual iterates below the infeasibility
        # certificates' noise guards
        c = jnp.clip(c * gamma, 1e-6, 1e6)
        return (D, E, c)

    D, E, c = lax.fori_loop(0, iters, body, (D, E, c))
    return Scaling(D=D, E=E, c=c)


class ScaledOps:
    """Wraps an operator bundle with Ruiz scalings: Abar = E A D,
    Pbar = c D P D, solving in the scaled space."""

    def __init__(self, inner, scaling: Scaling):
        self.inner = inner
        self.s = scaling

    def matvec_P(self, x):
        s = self.s
        return s.c * s.D * self.inner.matvec_P(s.D * x)

    def matvec_A(self, x):
        s = self.s
        return s.E * self.inner.matvec_A(s.D * x)

    def rmatvec_A(self, w):
        s = self.s
        return s.D * self.inner.rmatvec_A(s.E * w)

    def factorize(self, rho_vec, sigma_vec, cost_scale=1.0):
        # (c D P D + diag(sigma) + D A^T E R E A D) = D (cP + diag(sigma/D^2)
        #  + A^T (R E^2) A) D
        s = self.s
        return self.inner.factorize(
            rho_vec * s.E**2, sigma_vec / s.D**2, cost_scale * s.c
        )

    def kkt_solve(self, factor, rhs, rho_vec, sigma_vec, cost_scale=1.0):
        s = self.s
        x = self.inner.kkt_solve(
            factor, rhs / s.D, rho_vec * s.E**2, sigma_vec / s.D**2,
            cost_scale * s.c,
        )
        return x / s.D


def rho_vector(l, u, rho):
    """Per-row penalty following OSQP's classification: equality rows
    (u - l <= tol) get 1e3*rho, fully-loose rows get RHO_MIN, others rho."""
    eq = (u - l) <= _EQ_TOL
    loose = jnp.isinf(-l) & jnp.isinf(u)
    rho_vec = jnp.where(eq, 1e3 * rho, rho)
    rho_vec = jnp.where(loose, _LOOSE_RHO, rho_vec)
    return jnp.clip(rho_vec, _RHO_MIN, _RHO_MAX)


class _State(NamedTuple):
    x: jnp.ndarray
    z: jnp.ndarray
    y: jnp.ndarray
    rho: jnp.ndarray  # scalar base rho (adapted at epoch boundaries)
    it: jnp.ndarray
    prim_res: jnp.ndarray
    dual_res: jnp.ndarray
    done: jnp.ndarray
    prim_inf: jnp.ndarray
    dual_inf: jnp.ndarray
    # iterations until the next termination check (cfg.check_backoff_max)
    interval: jnp.ndarray
    # adaptive-rho epoch handshake: the inner (fixed-rho) loop exits with
    # refactor=True and the requested rho in rho_next; the outer loop
    # refactorizes and re-enters. Factorization is kept OUT of the hot
    # while body: a lax.cond whose branch runs full operator sweeps inside
    # the iterating while body was measured to double the per-iteration
    # cost of the whole loop on the accelerator this was first built for
    # (PARITY.md round 4); not measured on the H100.
    refactor: jnp.ndarray
    rho_next: jnp.ndarray


def admm_solve(
    ops,
    q,
    l,
    u,
    cfg: SolverConfig,
    x0=None,
    y0=None,
    scaling: Optional[Scaling] = None,
    rho0=None,
    eps_scale=None,
) -> QPSolution:
    """Run ADMM to the OSQP termination criterion.

    If `scaling` is provided the iteration runs in the equilibrated space
    while termination uses unscaled residuals (OSQP scaled_termination=False
    default); x0/y0 and the returned solution are always unscaled.

    `eps_scale` (traced scalar, default 1): multiplies both termination
    thresholds — the inexact-SCP hook (SolverConfig.eps_sched_iters): early
    SCP subproblems only seed the next linearization, so solving them to the
    final tolerance buys nothing (the reference itself solves EVERY QP at
    the loose OSQP_TOL, drone_params.py:4). Traced so one compiled program
    serves the whole schedule."""
    dtype = q.dtype
    n = q.shape[0]
    m = l.shape[0]

    if scaling is None:
        scaling = Scaling(
            D=jnp.ones(n, dtype), E=jnp.ones(m, dtype), c=jnp.ones((), dtype)
        )
        sops = ops
    else:
        sops = ScaledOps(ops, scaling)
    D, E, c = scaling.D, scaling.E, scaling.c

    qs = c * D * q
    ls = E * l
    us = E * u
    # scaled warm start
    x = jnp.zeros(n, dtype) if x0 is None else x0.astype(dtype) / D
    y = jnp.zeros(m, dtype) if y0 is None else y0.astype(dtype) * c / E
    z = jnp.clip(sops.matvec_A(x), ls, us)

    sigma_vec = jnp.full(n, cfg.sigma, dtype)
    alpha = jnp.asarray(cfg.alpha_relax, dtype)
    rho0 = jnp.asarray(cfg.rho if rho0 is None else rho0, dtype)
    rho0 = jnp.clip(rho0, _RHO_MIN, _RHO_MAX)
    _ruf = float(getattr(cfg, "rho_update_factor", 5.0))
    q_norm_unscaled = jnp.max(jnp.abs(q))
    eps_s = jnp.asarray(1.0 if eps_scale is None else eps_scale, dtype)

    factor0 = sops.factorize(rho_vector(ls, us, rho0), sigma_vec)

    # Periodic KKT refinement: each refinement pass inside kkt_solve costs
    # 2 extra G-sweeps (the memory-heavy core of the structured iteration), so
    # cfg.kkt_refine_period > 1 runs the refined solve only on every P-th
    # inner iteration and the cheap unrefined solve otherwise.
    period = int(getattr(cfg, "kkt_refine_period", 1))
    two_path = (
        period > 1
        and cfg.kkt_refine_iters > 0
        and hasattr(ops, "kkt_refine_iters")
    )
    if two_path:
        import copy as _copy

        _inner0 = _copy.copy(ops)
        _inner0.kkt_refine_iters = 0
        sops0 = _inner0 if scaling is None else ScaledOps(_inner0, scaling)

    def one_iter(x, z, y, rv, factor, refine_now=None):
        # rv = rho_vector(ls, us, rho) is loop-invariant within the
        # fixed-rho inner loop — hoisted to the caller (the where-chain
        # over the (m,) bounds costs small-op latency every iteration and
        # XLA does not reliably lift it out of the dynamic-trip fori)
        rhs = sigma_vec * x - qs + sops.rmatvec_A(rv * z - y)
        if refine_now is None:
            xt = sops.kkt_solve(factor, rhs, rv, sigma_vec)
        else:
            xt = lax.cond(
                refine_now,
                lambda: sops.kkt_solve(factor, rhs, rv, sigma_vec),
                lambda: sops0.kkt_solve(factor, rhs, rv, sigma_vec),
            )
        zt = sops.matvec_A(xt)
        x_next = alpha * xt + (1 - alpha) * x
        z_relax = alpha * zt + (1 - alpha) * z
        z_next = jnp.clip(z_relax + y / rv, ls, us)
        y_next = y + rv * (z_relax - z_next)
        return x_next, z_next, y_next

    def residuals(x, z, y):
        """Unscaled residuals + eps thresholds + scaled-ratio for rho."""
        Ax_s = sops.matvec_A(x)
        Px_s = sops.matvec_P(x)
        Aty_s = sops.rmatvec_A(y)
        # unscale: x_u = D x ; Ax_u = E^-1 Ax_s ; y_u = E y / c
        Ax = Ax_s / E
        zu = z / E
        Px = Px_s / (c * D)
        Aty = Aty_s / (c * D)
        prim = jnp.max(jnp.abs(Ax - zu))
        dual = jnp.max(jnp.abs(Px + q + Aty))
        eps_prim = eps_s * (cfg.eps_abs + cfg.eps_rel * jnp.maximum(
            jnp.max(jnp.abs(Ax)), jnp.max(jnp.abs(zu))
        ))
        eps_dual = eps_s * (cfg.eps_abs + cfg.eps_rel * jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Px)), jnp.max(jnp.abs(Aty))),
            q_norm_unscaled,
        ))
        # adaptive-rho ratio uses scaled residuals (OSQP sec 5.2)
        prim_s = jnp.max(jnp.abs(Ax_s - z))
        dual_s = jnp.max(jnp.abs(Px_s + qs + Aty_s))
        denom_p = jnp.maximum(jnp.max(jnp.abs(Ax_s)), jnp.max(jnp.abs(z))) + 1e-30
        denom_d = (
            jnp.maximum(
                jnp.maximum(jnp.max(jnp.abs(Px_s)), jnp.max(jnp.abs(Aty_s))),
                jnp.max(jnp.abs(qs)),
            )
            + 1e-30
        )
        ratio = (prim_s / denom_p) / (dual_s / denom_d + 1e-30)
        return prim, dual, eps_prim, eps_dual, ratio

    def certificate_terms(dy, dx, Atdy, Pdx, Adx):
        """OSQP infeasibility-certificate conditions (Stellato et al.
        sec 3.4) given the delta matvecs, all unscaled."""
        eps_inf = 1e-4
        dy_norm = jnp.max(jnp.abs(dy))
        sup = jnp.sum(
            jnp.where(dy > 0, jnp.where(jnp.isfinite(u), u, jnp.inf) * dy, 0.0)
        ) + jnp.sum(
            jnp.where(dy < 0, jnp.where(jnp.isfinite(l), l, -jnp.inf) * dy, 0.0)
        )
        prim_inf = (
            (dy_norm > 1e-10)
            & (jnp.max(jnp.abs(Atdy)) <= eps_inf * dy_norm)
            & (sup <= eps_inf * dy_norm)
        )

        dx_norm = jnp.max(jnp.abs(dx))
        cone_ok = jnp.all(
            jnp.where(
                jnp.isinf(u),
                jnp.where(jnp.isinf(-l), True, Adx >= -eps_inf * dx_norm),
                jnp.where(
                    jnp.isinf(-l),
                    Adx <= eps_inf * dx_norm,
                    jnp.abs(Adx) <= eps_inf * dx_norm,
                ),
            )
        )
        dual_inf = (
            (dx_norm > 1e-10)
            & (jnp.max(jnp.abs(Pdx)) <= eps_inf * dx_norm)
            & (jnp.dot(q, dx) <= eps_inf * dx_norm)
            & cone_ok
        )
        return prim_inf, dual_inf

    def infeasibility(x, y, s: "_State"):
        """Exact OSQP certificates from the between-check deltas, computed
        UNCONDITIONALLY at every termination check.

        A two-stage design (free prescreen from cached matvec deltas +
        lax.cond-gated exact confirmation) was tried and REMOVED: a
        lax.cond whose branch contains full operator sweeps, placed inside
        the solve loop's while body, doubled the per-iteration cost of the
        entire loop even when the branch never executed, on the
        accelerator this was first built for (PARITY.md round 4; not
        measured on the H100). The three explicit sweeps per check are
        amortized over check_every iterations."""
        dy = (y - s.y) * E / c  # unscaled dual delta
        dx = (x - s.x) * D  # unscaled primal delta
        return certificate_terms(
            dy, dx, ops.rmatvec_A(dy), ops.matvec_P(dx), ops.matvec_A(dx)
        )

    # Safeguarded type-II Anderson acceleration (OSQP v1 style), opt-in via
    # SolverConfig.anderson_depth > 0: the ADMM update is a fixed-point map
    # w -> T(w) on w = (x, z, y); keep the last `depth` (T(w), F = T(w)-w)
    # pairs, solve the Tikhonov-regularized least-squares
    #   min_a ||sum_i a_i F_i||  s.t.  sum_i a_i = 1
    # and take w+ = sum_i a_i T(w_i) when its predicted residual does not
    # exceed the plain step's (else fall back to T(w)). History lives in
    # the inner fori carry, so it restarts at every termination check /
    # rho epoch — a built-in restart schedule.
    depth = int(getattr(cfg, "anderson_depth", 0))
    aa_lam = 1e-8

    def aa_step(w_hist, f_hist, cnt, g, f):
        """Update history with (g, f) and return the accelerated w.

        Circular buffer (single-row dynamic update) rather than a roll:
        the least-squares combination is row-order-independent, and
        rolling two (depth, nw) buffers every iteration costs ~4x the
        history's size in memory traffic per iteration."""
        slot = jnp.mod(cnt, depth)
        w_hist = lax.dynamic_update_index_in_dim(w_hist, g, slot, 0)
        f_hist = lax.dynamic_update_index_in_dim(f_hist, f, slot, 0)
        cnt = cnt + 1
        valid = jnp.arange(depth) < jnp.minimum(cnt, depth)
        Fm = jnp.where(valid[:, None], f_hist, 0.0)
        gram = Fm @ Fm.T
        scale = jnp.trace(gram) / jnp.maximum(jnp.sum(valid), 1) + 1e-30
        gram = gram + aa_lam * scale * jnp.eye(depth, dtype=dtype)
        # invalid rows/cols -> identity so their coefficients solve to 0
        vv = jnp.outer(valid, valid)
        gram = jnp.where(vv, gram, jnp.eye(depth, dtype=dtype))
        beta = jnp.linalg.solve(gram, valid.astype(dtype))
        a = beta / (jnp.sum(beta) + 1e-30)
        a = jnp.where(valid, a, 0.0)
        w_acc = a @ w_hist
        # predicted residual of the combination vs the plain step's
        r_acc = a @ Fm
        ok = (
            jnp.all(jnp.isfinite(w_acc))
            & (jnp.sum(r_acc * r_acc) <= jnp.sum(f * f))
        )
        w_new = jnp.where(ok, w_acc, g)
        return w_hist, f_hist, cnt, w_new

    def make_body(factor):
        """Inner fixed-rho loop body; `factor` is loop-invariant so the
        compiler can pipeline the G-streaming iteration without the
        carried-factor copies a conditional refactorization would force."""

        def body(s: _State):
            rv = rho_vector(ls, us, s.rho)  # fixed within this inner loop

            def inner(j, xzy):
                x, z, y = xzy
                refine_now = ((s.it + j) % period == 0) if two_path else None
                return one_iter(x, z, y, rv, factor, refine_now)

            if depth > 0:
                nw = n + 2 * m

                def inner_aa(j, carry):
                    x, z, y, w_hist, f_hist, cnt = carry
                    refine_now = (
                        ((s.it + j) % period == 0) if two_path else None
                    )
                    xp, zp, yp = one_iter(x, z, y, rv, factor, refine_now)
                    w = jnp.concatenate([x, z, y])
                    g = jnp.concatenate([xp, zp, yp])
                    w_hist, f_hist, cnt, w_new = aa_step(
                        w_hist, f_hist, cnt, g, g - w
                    )
                    return (
                        w_new[:n], w_new[n:n + m], w_new[n + m:],
                        w_hist, f_hist, cnt,
                    )

                x, z, y, _, _, _ = lax.fori_loop(
                    0, s.interval, inner_aa,
                    (
                        s.x, s.z, s.y,
                        jnp.zeros((depth, nw), dtype),
                        jnp.zeros((depth, nw), dtype),
                        jnp.zeros((), jnp.int32),
                    ),
                )
            else:
                x, z, y = lax.fori_loop(
                    0, s.interval, inner, (s.x, s.z, s.y)
                )
            prim, dual, eps_prim, eps_dual, ratio = residuals(x, z, y)
            solved = (prim <= eps_prim) & (dual <= eps_dual)
            prim_inf, dual_inf = infeasibility(x, y, s)

            base_iv = jnp.asarray(cfg.check_every, jnp.int32)
            if cfg.check_backoff_max > 1:
                far = (prim > 100.0 * eps_prim) | (dual > 100.0 * eps_dual)
                iv = jnp.where(
                    far,
                    jnp.minimum(
                        2 * s.interval, cfg.check_backoff_max * base_iv
                    ),
                    base_iv,
                )
            else:
                iv = base_iv
            # never overshoot the iteration cap by more than the final check
            iv = jnp.maximum(
                jnp.minimum(iv, cfg.max_iter - (s.it + s.interval)), 1
            ).astype(jnp.int32)

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

            return _State(
                x=x,
                z=z,
                y=y,
                rho=s.rho,
                it=s.it + s.interval,
                prim_res=prim,
                dual_res=dual,
                done=solved | prim_inf | dual_inf,
                prim_inf=prim_inf,
                dual_inf=dual_inf,
                interval=iv,
                refactor=refactor,
                rho_next=rho_new,
            )

        return body

    def inner_cond(s: _State):
        return (
            jnp.logical_not(s.done)
            & jnp.logical_not(s.refactor)
            & (s.it < cfg.max_iter)
        )

    init = _State(
        x=x,
        z=z,
        y=y,
        rho=rho0,
        it=jnp.zeros((), jnp.int32),
        prim_res=jnp.asarray(jnp.inf, dtype),
        dual_res=jnp.asarray(jnp.inf, dtype),
        done=jnp.asarray(False),
        prim_inf=jnp.asarray(False),
        dual_inf=jnp.asarray(False),
        interval=jnp.asarray(cfg.check_every, jnp.int32),
        refactor=jnp.asarray(False),
        rho_next=rho0,
    )

    if cfg.adaptive_rho:
        # Two-level loop: the outer body refactorizes (unconditionally —
        # it only runs at rho-epoch boundaries) and the inner while
        # iterates at fixed (rho, factor). Same update schedule as the
        # former cond-refactorize-in-body form, at most one extra
        # factorization total, and the hot loop stays conditional-free.
        def outer_cond(c):
            s, _ = c
            return jnp.logical_not(s.done) & (s.it < cfg.max_iter)

        epoch = int(getattr(cfg, "rho_epoch_every", 0))
        if epoch > 0:
            # Fixed-cadence epochs (cfg.rho_epoch_every): mid-epoch
            # refactor requests are deferred to the epoch boundary. Keeps
            # every vmapped batch element's epoch schedule ALIGNED — the
            # event-driven handshake below freezes an element that wants a
            # refactor until the whole batch exits the inner loop, which
            # desynchronizes rho adaptation and inflates both iteration
            # counts and wall time (PARITY.md round 3).
            def outer_body(c):
                s, factor = c
                end = jnp.minimum(s.it + epoch, cfg.max_iter)

                def icond(s2):
                    return jnp.logical_not(s2.done) & (s2.it < end)

                s = lax.while_loop(icond, make_body(factor), s)
                rho2 = jnp.where(s.refactor, s.rho_next, s.rho)
                factor2 = sops.factorize(rho_vector(ls, us, rho2), sigma_vec)
                return (
                    s._replace(rho=rho2, refactor=jnp.asarray(False)),
                    factor2,
                )
        else:
            def outer_body(c):
                s, factor = c
                s = lax.while_loop(inner_cond, make_body(factor), s)
                rho2 = jnp.where(s.refactor, s.rho_next, s.rho)
                factor2 = sops.factorize(rho_vector(ls, us, rho2), sigma_vec)
                return (
                    s._replace(rho=rho2, refactor=jnp.asarray(False)),
                    factor2,
                )

        s, _ = lax.while_loop(outer_cond, outer_body, (init, factor0))
    else:
        s = lax.while_loop(inner_cond, make_body(factor0), init)

    # unscale
    x_u = D * s.x
    y_u = E * s.y / c
    z_u = s.z / E

    if cfg.polish:
        x_u, y_u, z_u = _polish(ops, q, l, u, x_u, y_u, z_u, cfg)

    return QPSolution(
        x=x_u,
        y=y_u,
        z=z_u,
        iters=s.it,
        prim_res=s.prim_res,
        dual_res=s.dual_res,
        solved=s.done & jnp.logical_not(s.prim_inf | s.dual_inf),
        prim_infeasible=s.prim_inf,
        dual_infeasible=s.dual_inf,
        rho=s.rho,
    )


def _polish(ops, q, l, u, x, y, z, cfg, eq_mask=None, active_masks=None):
    """Static-shape analog of OSQP polishing: solve the KKT system with the
    active rows treated as (stiff) equalities and inactive rows dropped.

    OSQP builds a reduced equality-constrained KKT from the active set; a
    reduced system has a dynamic shape under jit, so instead we solve
    (P + sigma_p I + A^T W A) x = -q + A^T W b with W = w_big on active rows
    and 0 elsewhere, b the active bound — equivalent in the w_big limit —
    followed by refinement steps. Duals of active rows are recovered from the
    penalty residual. Polish is accepted only if it improves both residuals
    (OSQP behavior)."""
    dtype = q.dtype
    n = q.shape[0]
    # Penalty weight is dtype-aware: the normal-equations system P + A^T W A
    # squares the constraint conditioning, so in f32 W = 1e7 produces a
    # factor with relative error >> 1 (observed: residuals ~1e7). A moderate
    # W only biases the PRECONDITIONER here — accuracy comes from the exact
    # KKT refinement below, whose residuals involve only O(1) magnitudes.
    f32 = jnp.finfo(dtype).bits <= 32
    w_big = jnp.asarray(1e4 if f32 else 1e7, dtype)
    sigma_p = jnp.full(n, 1e-7 if f32 else 1e-9, dtype)
    if active_masks is not None:
        # caller-supplied active set (e.g. IPM's lambda > s detection — IPM
        # duals are strictly interior so sign-based detection over-selects)
        lower_active, upper_active = active_masks
    else:
        # Dual sign (OSQP's rule) with a RELATIVE dtype-aware threshold.
        # Inactive-row duals decay to ~eps-scale noise (the z-projection is
        # the identity there so each ADMM step multiplies y by 0 up to
        # roundoff) — in f32 that noise is ~1e-9 and an absolute 1e-12 bar
        # sweeps merely-nearby rows into the active set, which (observed)
        # poisons the forced-equality solve far beyond accept-and-reject
        # recovery. eps^0.75 * ||y||_inf keeps the classic 1e-12 behavior in
        # f64 and sits at ~4e-6 in f32: above projection noise, below any
        # dual that meaningfully binds; rows misjudged either way are
        # corrected by the wrong-sign drop pass below and the
        # accept-only-if-better guard.
        y_tol = jnp.finfo(dtype).eps ** 0.75 * jnp.maximum(
            1.0, jnp.max(jnp.abs(y))
        )
        lower_active = y < -y_tol
        upper_active = y > y_tol
    if eq_mask is not None:
        # equality rows are always in the active set regardless of their
        # multiplier sign (l == u there so the bound choice is immaterial)
        lower_active = lower_active | eq_mask
    eq_like = lower_active & upper_active

    def solve_with(low, up):
        """Equality-KKT solve on the active set {low | up}, penalty factor
        as preconditioner + exact-residual refinement.

        Refines the TRUE system
          [P  A_act^T] [x]   [-q   ]
          [A_act   0 ] [y] = [b_act]
        — residuals are computed against the exact KKT (all O(1) magnitudes,
        f32-safe, unlike the penalty normal equations whose residual carries
        an O(W*eps) floor), and each step contracts by the preconditioner's
        O(1/W + kappa*eps) relative error."""
        active = low | up
        b = jnp.where(low, l, jnp.where(up, u, 0.0))
        b = jnp.where(jnp.isfinite(b), b, 0.0)
        w = jnp.where(active, w_big, 0.0)
        factor = ops.factorize(w, sigma_p, 1.0)
        rhs = -q + ops.rmatvec_A(w * b)
        x_pol = ops.kkt_solve(factor, rhs, w, sigma_p, 1.0)
        y_pol = jnp.where(active, w * (ops.matvec_A(x_pol) - b), 0.0)

        def refine(_, carry):
            x_pol, y_pol = carry
            r_x = -q - ops.matvec_P(x_pol) - ops.rmatvec_A(y_pol)
            r_b = jnp.where(active, b - ops.matvec_A(x_pol), 0.0)
            dx = ops.kkt_solve(
                factor, r_x + ops.rmatvec_A(w * r_b), w, sigma_p, 1.0
            )
            dy = jnp.where(active, w * (ops.matvec_A(dx) - r_b), 0.0)
            return x_pol + dx, y_pol + dy

        return lax.fori_loop(
            0, cfg.polish_refine_iters, refine, (x_pol, y_pol)
        )

    x_pol, y_pol = solve_with(lower_active, upper_active)

    # Active-set correction pass: the proximity rescue above over-selects
    # (a merely-nearby inactive row forced to its bound takes a wrong-sign
    # multiplier — relaxing it would improve the objective). Drop those rows
    # and re-solve once; equality rows are never dropped.
    s_tol = jnp.sqrt(jnp.finfo(dtype).eps) * jnp.maximum(
        1.0, jnp.max(jnp.abs(y_pol))
    )
    droppable = ~eq_like if eq_mask is None else ~(eq_like | eq_mask)
    wrong = droppable & (
        (lower_active & ~upper_active & (y_pol > s_tol))
        | (upper_active & ~lower_active & (y_pol < -s_tol))
    )
    lower_active = lower_active & ~wrong
    upper_active = upper_active & ~wrong
    x_pol, y_pol = lax.cond(
        jnp.any(wrong),
        lambda: solve_with(lower_active, upper_active),
        lambda: (x_pol, y_pol),
    )

    Ax = ops.matvec_A(x_pol)
    z_pol = jnp.clip(Ax, l, u)

    def resid(xx, yy, zz):
        prim = jnp.max(jnp.abs(ops.matvec_A(xx) - zz))
        dual = jnp.max(jnp.abs(ops.matvec_P(xx) + q + ops.rmatvec_A(yy)))
        return prim, dual

    p0, d0 = resid(x, y, z)
    p1, d1 = resid(x_pol, y_pol, z_pol)
    better = (p1 <= jnp.maximum(p0, 1e-10)) & (d1 <= jnp.maximum(d0, 1e-10))
    pick = lambda a, bb: jnp.where(better, a, bb)
    return pick(x_pol, x), pick(y_pol, y), pick(z_pol, z)


class DenseQPOps:
    """Dense instantiation: P (n,n), A (m,n) materialized; KKT solved by
    Cholesky of cP + diag(sigma) + A^T R A with optional iterative refinement
    (helps f32, SURVEY.md section 7.3.1-2)."""

    def __init__(self, P, A, kkt_refine_iters: int = 1):
        self.P = P
        self.A = A
        self.kkt_refine_iters = kkt_refine_iters

    def matvec_P(self, x):
        return self.P @ x

    def matvec_A(self, x):
        return self.A @ x

    def rmatvec_A(self, w):
        return self.A.T @ w

    def row_inf_norms(self, D):
        return jnp.max(jnp.abs(self.A) * D[None, :], axis=1)

    def col_inf_norms(self, E):
        return jnp.max(E[:, None] * jnp.abs(self.A), axis=0)

    def col_inf_norms_P(self, D):
        return jnp.max(D[:, None] * jnp.abs(self.P), axis=0)

    def _kkt_matrix(self, rho_vec, sigma_vec, cost_scale):
        return (
            cost_scale * self.P
            + jnp.diag(sigma_vec)
            + self.A.T @ (rho_vec[:, None] * self.A)
        )

    def factorize(self, rho_vec, sigma_vec, cost_scale=1.0):
        return jnp.linalg.cholesky(self._kkt_matrix(rho_vec, sigma_vec, cost_scale))

    def kkt_solve(self, chol, rhs, rho_vec, sigma_vec, cost_scale=1.0):
        def solve(r):
            t = jax.scipy.linalg.solve_triangular(chol, r, lower=True)
            return jax.scipy.linalg.solve_triangular(chol.T, t, lower=False)

        x = solve(rhs)
        for _ in range(self.kkt_refine_iters):
            r = rhs - (
                cost_scale * (self.P @ x)
                + sigma_vec * x
                + self.A.T @ (rho_vec * (self.A @ x))
            )
            x = x + solve(r)
        return x


def solve_dense_qp(
    P,
    q,
    A,
    l,
    u,
    cfg: SolverConfig = SolverConfig(),
    x0=None,
    y0=None,
    scale: bool = True,
    ruiz_iters: int = 5,
) -> QPSolution:
    """One-call dense QP solve (OSQP setup+solve equivalent)."""
    ops = DenseQPOps(P, A, kkt_refine_iters=cfg.kkt_refine_iters)
    scaling = ruiz_equilibrate(ops, q, l, u, iters=ruiz_iters) if scale else None
    return admm_solve(ops, q, l, u, cfg, x0=x0, y0=y0, scaling=scaling)
