"""Nonlinear-programming interior-point solver (IPOPT-equivalent), fully
jitted: replaces the reference's ipyopt/IPOPT dependency for the hopper
direct transcription (hopper/hopper.py:646-669) and the drone Gaussian NLP
(drone/drone_gaussian.py:503-526).

The reference pays a C++ -> Python -> XLA round trip per IPOPT callback
evaluation on a dense 400-var/~1100-row problem (SURVEY.md section 3.3); here
the entire barrier algorithm — constraint/Jacobian/Lagrangian-Hessian
evaluation, the reduced Newton solve, fraction-to-boundary line search and the
monotone Fiacco-McCormick mu-schedule — is one `lax.while_loop` on-chip.

Problem form:
    min f(Z)   s.t.  gL <= g(Z) <= gU   (first n_eq rows equalities),
                     xL <= Z <= xU
Box bounds are folded in as identity constraint rows; inequality rows get
slacks with log barriers on their finite sides; equality rows are eliminated
exactly through a dense Schur complement (same algebra as ops/ipm.py).

Newton system per iteration (W_l = Lam_l S_l^-1 etc., D = W_l + W_u):
    [H + tau I + J_in^T D J_in] dZ + J_eq^T dy = -r
    J_eq dZ = -r_eq
Step acceptance: backtracking Armijo on the barrier merit
    phi = f - mu sum(log s) + nu * ||constraint residuals||_1
with adaptive regularization tau (inertia-correction stand-in) and adaptive
penalty nu.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class NLPConfig(NamedTuple):
    tol: float = 1e-6
    max_iter: int = 300
    mu_init: float = 1e-1
    kappa_mu: float = 0.2  # IPOPT linear mu decrease factor
    theta_mu: float = 1.5  # IPOPT superlinear mu exponent
    kappa_eps: float = 10.0  # barrier-problem tolerance = kappa_eps * mu
    tau_min: float = 0.99  # fraction-to-boundary floor
    bound_push: float = 1e-2  # initial point push-off from bounds
    tau_reg_init: float = 1e-8
    tau_reg_max: float = 1e6
    max_backtracks: int = 12
    nu_init: float = 1.0
    nu_margin: float = 10.0
    # IPOPT gradient-based NLP scaling (nlp_scaling_max_gradient): scale f
    # and each constraint row so first-derivative magnitudes at Z0 are <= this
    # (essential for the hopper's 1e7 slack-penalty gradient)
    scaling_max_gradient: float = 100.0
    # barrier-parameter strategy: 'loqo' (adaptive, IPOPT mu_oracle=loqo;
    # tracks the iterate's actual complementarity) or 'monotone'
    # (Fiacco-McCormick schedule)
    mu_strategy: str = "loqo"
    # Symmetric Ruiz equilibration sweeps on the augmented KKT matrix before
    # the LU factorization. The raw system's conditioning (~1e8 on the
    # hopper) exceeds 1/eps_f32, so single-precision Newton directions are
    # garbage and the f32 solve wanders into poor local basins; equilibrated
    # rows/columns recover usable f32 directions. 0 = off (f64 needs none).
    kkt_ruiz_iters: int = 0
    # Compensated (double-single) line-search merit: the barrier merit on
    # the hopper is O(1e5) while meaningful per-step decrements near the
    # central path are O(1e-3) — far below f32 resolution (~0.01 at that
    # magnitude), so the f32 Armijo test becomes a coin flip and the solve
    # stalls on rejected steps. Computes the merit's large sums and the
    # accept-test DIFFERENCE in ds arithmetic (ops/dsjit). Off by default
    # (f64 needs none).
    merit_compensated: bool = False
    # Compensated (double-single) iterative refinement rounds on the
    # augmented-KKT LU solve: each round recomputes the residual
    # rhs - K @ sol in double-single arithmetic (ops/dsjit.dot2) and
    # accumulates the solution itself as a ds pair, so the Newton
    # direction's accuracy is limited by the EQUILIBRATED condition number
    # times eps^2 instead of eps — the f32 direction error (~1e-3 relative
    # on the hopper's cond~1e8 system even after Ruiz) is what steers the
    # cold f32 solve into wrong basins of the nonconvex contact problem.
    # 0 = off (f64 needs none). Use together with kkt_ruiz_iters: without
    # equilibration the per-round contraction factor cond*eps exceeds 1
    # and refinement cannot converge.
    kkt_ds_refine_iters: int = 0
    # Step damping for the first `damp_iters` barrier iterations: cap the
    # fraction-to-boundary primal step at `damp_max`. The cold hopper
    # solve commits to a basin in its first few large barrier steps; in
    # reduced precision those steps are taken along directions with the
    # largest relative error of the whole solve (huge mu, cond peak), so
    # bounding them keeps the early iterates inside the basin the exact
    # path would take. 0 = off.
    damp_iters: int = 0
    damp_max: float = 0.1
    # Second-order correction (IPOPT sec 2.4 / Wachter-Biegler eq. 27): when
    # the full trial step is rejected, re-solve the SAME KKT factorization
    # with the equality rhs replaced by the SOC residual
    # a*c(x_k) + c(x_k + a*dZ) — one extra constraint evaluation + LU
    # back-substitution — and take the corrected step if IT passes the line
    # search. Corrects for constraint curvature that the linear model misses
    # (RK4 defect rows); applied to equality rows (the curvature carriers
    # here), inequalities keep their slacked rhs. Off by default.
    soc: bool = False


class NLPResult(NamedTuple):
    Z: jnp.ndarray
    y_eq: jnp.ndarray
    lam_l: jnp.ndarray
    lam_u: jnp.ndarray
    iters: jnp.ndarray
    prim_res: jnp.ndarray
    dual_res: jnp.ndarray
    comp_res: jnp.ndarray
    solved: jnp.ndarray
    f_val: jnp.ndarray


def classify_rows(g_L, g_U, n_eq: int):
    """Equality-row reclassification permutation, computed host-side.

    IPOPT treats any row with gL == gU as an equality; rows like the
    hopper's flight-phase contact-force pins (l = u = 0 inside the
    "inequality" section, hopper.py:416-421) would otherwise make the slack
    barrier infeasible (s_l + s_u must equal u - l = 0 > impossible).
    Bounds must be CONCRETE here. Jitted callers of `solve_nlp` precompute
    (perm, n_eq) with this helper and pass `row_perm=` so the bound arrays
    themselves can stay traced jit arguments (see `solve_nlp` notes on the
    target runtime's jaxpr-constant penalty)."""
    import numpy as _np

    gLn = _np.asarray(g_L)
    gUn = _np.asarray(g_U)
    eq_mask_np = (gUn - gLn) <= 1e-12
    eq_mask_np[:n_eq] = True
    perm = _np.concatenate(
        [_np.where(eq_mask_np)[0], _np.where(~eq_mask_np)[0]]
    )
    return perm, int(eq_mask_np.sum())


def solve_nlp(
    f_fn: Callable,
    g_fn: Callable,
    g_L,
    g_U,
    n_eq: int,
    x_L,
    x_U,
    Z0,
    cfg: NLPConfig = NLPConfig(),
    trace_iters: int = 0,
    params=None,
    row_perm=None,
) -> NLPResult:
    """Solve the NLP from initial guess Z0 (the reference's two-phase
    baseline->SAA warm-start workflow maps to calling this twice,
    hopper/README.md:9-25).

    Arg-rooting (models/base.ConstBind rationale): a barrier solve whose
    f/g closures capture problem arrays (e.g. the hopper friction field)
    bakes them into the jaxpr as constants. Pass those arrays as the
    `params` pytree instead — the
    callbacks are then invoked as ``f_fn(Z, params)`` / ``g_fn(Z, params)``
    — and jit `solve_nlp` with (Z0, params, bounds) as traced arguments.
    When bounds are traced, the host-side equality reclassification cannot
    read them: precompute ``row_perm=classify_rows(g_L, g_U, n_eq)`` outside
    jit. `params` also makes the solver vmappable over problem instances
    (batched NLP solves — the batched-problem axis of SURVEY.md 2.3)."""
    if params is not None:
        f_user, g_user = f_fn, g_fn
        f_fn = lambda Z: f_user(Z, params)  # noqa: E731
        g_fn = lambda Z: g_user(Z, params)  # noqa: E731
    dtype = Z0.dtype
    n = Z0.shape[0]
    m_g = g_L.shape[0]

    # -- reclassify zero-gap rows as equalities (see classify_rows) --------
    perm, n_eq = (
        classify_rows(g_L, g_U, n_eq) if row_perm is None else row_perm
    )
    perm_j = jnp.asarray(perm)
    g_fn_orig = g_fn
    g_fn = lambda Z: g_fn_orig(Z)[perm_j]  # noqa: E731
    g_L = jnp.asarray(g_L, dtype)[perm_j]
    g_U = jnp.asarray(g_U, dtype)[perm_j]

    # -- IPOPT gradient-based problem scaling at Z0 ------------------------
    # (nlp_scaling_max_gradient: scale the objective and each constraint row
    # so that first derivatives at the start point are at most g_max; without
    # this the hopper's 1e7 slack gradient swamps the barrier algebra)
    g_max = cfg.scaling_max_gradient
    gf0 = jax.grad(f_fn)(Z0)
    scale_f = jnp.minimum(1.0, g_max / jnp.maximum(jnp.max(jnp.abs(gf0)), 1e-8))
    if m_g > 0:
        J_g0 = jax.jacfwd(g_fn)(Z0)
        row_norms0 = jnp.max(jnp.abs(J_g0), axis=1)
        row_scale = jnp.minimum(1.0, g_max / jnp.maximum(row_norms0, 1e-8))
    else:
        row_scale = jnp.zeros(0, dtype)

    f_raw, g_raw = f_fn, g_fn
    f_fn = lambda Z: scale_f * f_raw(Z)
    g_fn = lambda Z: row_scale * g_raw(Z)
    big = 1e15
    g_L = jnp.where(jnp.abs(g_L) < 1e14, row_scale * g_L, g_L)
    g_U = jnp.where(jnp.abs(g_U) < 1e14, row_scale * g_U, g_U)

    # fold box bounds in as identity rows after the g rows. The stack is
    # pinned to Z0's dtype: an f32 solve with f64-valued problem constants
    # in the callbacks (possible when x64 is enabled globally) must not
    # silently promote — mixed dtypes break the LU solve and would hide
    # the f32 code path under f64 arithmetic.
    _f_any = f_fn
    f_fn = lambda Z: jnp.asarray(_f_any(Z), dtype)  # noqa: E731

    def c_fn(Z):
        return jnp.concatenate([g_fn(Z).astype(dtype), Z])

    c_L = jnp.concatenate([g_L, x_L]).astype(dtype)
    c_U = jnp.concatenate([g_U, x_U]).astype(dtype)
    m = m_g + n
    mi = m - n_eq

    b_eq = c_L[:n_eq]
    l_in = c_L[n_eq:]
    u_in = c_U[n_eq:]
    has_l = l_in > -1e14  # reference uses -1e15 as "no bound"
    has_u = u_in < 1e14
    n_sides = jnp.maximum(jnp.sum(has_l) + jnp.sum(has_u), 1).astype(dtype)

    grad_f = jax.grad(f_fn)
    jac_c = jax.jacfwd(c_fn)

    def lagrangian(Z, y_eq, lam_in):
        c = c_fn(Z)
        return f_fn(Z) + jnp.dot(y_eq, c[:n_eq]) + jnp.dot(lam_in, c[n_eq:])

    hess_lag = jax.hessian(lagrangian, argnums=0)

    # -- initial point ------------------------------------------------------
    push = cfg.bound_push * jnp.maximum(1.0, jnp.abs(x_L))
    Z_init = jnp.clip(
        Z0,
        jnp.where(x_L > -1e14, x_L + push, -jnp.inf),
        jnp.where(x_U < 1e14, x_U - cfg.bound_push * jnp.maximum(1.0, jnp.abs(x_U)), jnp.inf),
    )
    c0 = c_fn(Z_init)[n_eq:]
    s_l0 = jnp.where(has_l, jnp.maximum(c0 - l_in, cfg.bound_push), 1.0)
    s_u0 = jnp.where(has_u, jnp.maximum(u_in - c0, cfg.bound_push), 1.0)
    # centered multiplier initialization lam = mu/s (keeps the initial
    # complementarity residual at zero even for huge slacks like the
    # hopper's 1e6 slack upper bound)
    lam_l_init = jnp.where(has_l, cfg.mu_init / s_l0, 0.0)
    lam_u_init = jnp.where(has_u, cfg.mu_init / s_u0, 0.0)

    class _S(NamedTuple):
        Z: jnp.ndarray
        y_eq: jnp.ndarray
        s_l: jnp.ndarray
        s_u: jnp.ndarray
        lam_l: jnp.ndarray
        lam_u: jnp.ndarray
        mu: jnp.ndarray
        tau_reg: jnp.ndarray
        nu: jnp.ndarray
        it: jnp.ndarray
        prim: jnp.ndarray
        dual: jnp.ndarray
        comp: jnp.ndarray
        done: jnp.ndarray
        a_p: jnp.ndarray  # diagnostics: last primal step length
        ok: jnp.ndarray  # diagnostics: last line-search success
        d_tau_used: jnp.ndarray
        d_maxD: jnp.ndarray
        d_minsl: jnp.ndarray
        d_dynorm: jnp.ndarray
        d_theta: jnp.ndarray

    def kkt_errors(Z, y_eq, s_l, s_u, lam_l, lam_u, mu):
        c = c_fn(Z)
        J = jac_c(Z)
        r_eq = c[:n_eq] - b_eq
        ci = c[n_eq:]
        r_l = jnp.where(has_l, ci - s_l - l_in, 0.0)
        r_u = jnp.where(has_u, u_in - ci - s_u, 0.0)
        lam_in = lam_u - lam_l
        r_d = grad_f(Z) + J[:n_eq].T @ y_eq + J[n_eq:].T @ lam_in
        comp = jnp.maximum(
            jnp.max(jnp.abs(jnp.where(has_l, s_l * lam_l - mu, 0.0))),
            jnp.max(jnp.abs(jnp.where(has_u, s_u * lam_u - mu, 0.0))),
        )
        # IPOPT scaling s_d for the dual residual
        lam_sum = jnp.sum(jnp.abs(lam_l)) + jnp.sum(jnp.abs(lam_u)) + jnp.sum(
            jnp.abs(y_eq)
        )
        s_d = jnp.maximum(100.0, lam_sum / jnp.maximum(m, 1)) / 100.0
        prim = jnp.maximum(
            jnp.max(jnp.abs(r_eq), initial=0.0),
            jnp.maximum(jnp.max(jnp.abs(r_l)), jnp.max(jnp.abs(r_u))),
        )
        dual = jnp.max(jnp.abs(r_d)) / s_d
        return c, J, r_eq, r_l, r_u, r_d, prim, dual, comp

    def merit(Z, s_l, s_u, mu, nu):
        """Returns ((phi_hi, phi_lo), theta). In the default mode phi_lo is
        zero; with cfg.merit_compensated the merit's sums are accumulated in
        double-single so the line search can resolve decrements ~eps^2 of
        the merit magnitude (see NLPConfig)."""
        c = c_fn(Z)
        logs_l = jnp.where(has_l, jnp.log(jnp.maximum(s_l, 1e-300)), 0.0)
        logs_u = jnp.where(has_u, jnp.log(jnp.maximum(s_u, 1e-300)), 0.0)
        t_eq = jnp.abs(c[:n_eq] - b_eq)
        t_l = jnp.abs(jnp.where(has_l, c[n_eq:] - s_l - l_in, 0.0))
        t_u = jnp.abs(jnp.where(has_u, u_in - c[n_eq:] - s_u, 0.0))
        if not cfg.merit_compensated:
            barrier = -mu * (jnp.sum(logs_l) + jnp.sum(logs_u))
            theta = jnp.sum(t_eq) + jnp.sum(t_l) + jnp.sum(t_u)
            return (f_fn(Z) + barrier + nu * theta,
                    jnp.zeros_like(barrier)), theta
        from riskaversetrajopt_tpu.ops import dsjit as ds

        bh, bl = ds.ds_add(*ds.sum1_ds(logs_l), *ds.sum1_ds(logs_u))
        bh, bl = ds.ds_scale(bh, bl, -mu)
        th, tl = ds.ds_add(*ds.sum1_ds(t_eq), *ds.ds_add(
            *ds.sum1_ds(t_l), *ds.sum1_ds(t_u)))
        nh, nl = ds.ds_scale(th, tl, nu)
        ph, pl = ds.ds_add(bh, bl, nh, nl)
        ph, pl = ds.ds_add(ph, pl, f_fn(Z), jnp.zeros_like(ph))
        return (ph, pl), th

    def body(s: _S):
        c, J, r_eq, r_l, r_u, r_d, prim, dual, comp = kkt_errors(
            s.Z, s.y_eq, s.s_l, s.s_u, s.lam_l, s.lam_u, s.mu
        )
        J_eq = J[:n_eq]
        J_in = J[n_eq:]

        H = hess_lag(s.Z, s.y_eq, s.lam_u - s.lam_l)
        H = 0.5 * (H + H.T)

        w_l = jnp.where(has_l, s.lam_l / s.s_l, 0.0)
        w_u = jnp.where(has_u, s.lam_u / s.s_u, 0.0)
        D = w_l + w_u

        # complementarity residuals for the centered step
        r_cl = jnp.where(has_l, s.s_l * s.lam_l - s.mu, 0.0)
        r_cu = jnp.where(has_u, s.s_u * s.lam_u - s.mu, 0.0)

        v = (
            jnp.where(has_u, r_cu / s.s_u, 0.0)
            + w_u * r_u
            - jnp.where(has_l, r_cl / s.s_l, 0.0)
            - w_l * r_l
        )

        # Augmented (indefinite) KKT system, IPOPT-style: forming the normal
        # equations J^T D J squares the conditioning and near-active rows
        # (D -> inf) wipe out all other curvature; in the augmented form the
        # same rows contribute -1/D -> 0 — benign. Solved by LU.
        #   [[H + tau I,  J^T       ] [dZ ]   [-r_d    ]
        #    [J,         diag(block)]] [dy ] = [rhs_rows]
        # block: -delta on eq rows, -1/D on ineq rows (loose rows: D=0 ->
        # -1/eps, pinning dy ~ 0).
        delta_eq = 1e-8
        D_safe = jnp.clip(D, 1e-20, 1e20)
        diag_block = jnp.concatenate(
            [jnp.full(n_eq, -delta_eq, dtype), -1.0 / D_safe]
        )
        # per-row equation: dy_i = D_i (J_i dZ) - v_i, rearranged to
        # J_i dZ - dy_i / D_i = v_i / D_i
        rhs_rows = jnp.concatenate([-r_eq, v / D_safe])
        tau_used = s.tau_reg
        K = jnp.zeros((n + m, n + m), dtype)
        K = K.at[:n, :n].set(H + tau_used * jnp.eye(n, dtype=dtype))
        K = K.at[:n, n:].set(J.T)
        K = K.at[n:, :n].set(J)
        K = K.at[n + jnp.arange(m), n + jnp.arange(m)].set(diag_block)
        if cfg.kkt_ruiz_iters > 0:
            # symmetric Ruiz: d K d -> unit row inf-norms (see NLPConfig)
            d_eq = jnp.ones(n + m, dtype)
            Ks = K
            for _ in range(cfg.kkt_ruiz_iters):
                rn = jnp.max(jnp.abs(Ks), axis=1)
                d_new = 1.0 / jnp.sqrt(jnp.clip(rn, 1e-12, 1e12))
                d_eq = d_eq * d_new
                Ks = (d_new[:, None] * Ks) * d_new[None, :]
        else:
            d_eq = None
            Ks = K
        lu, piv = jax.scipy.linalg.lu_factor(Ks)

        def lu_apply(r):
            if d_eq is None:
                return jax.scipy.linalg.lu_solve((lu, piv), r)
            # K x = r  <=>  (dKd)(d^-1 x) = d r
            return d_eq * jax.scipy.linalg.lu_solve((lu, piv), d_eq * r)

        def solve_kkt(rhs_full):
            sol = lu_apply(rhs_full)
            if cfg.kkt_ds_refine_iters <= 0:
                # one step of iterative refinement against the ORIGINAL system
                return sol + lu_apply(rhs_full - K @ sol)
            # compensated refinement (see NLPConfig.kkt_ds_refine_iters):
            # ds-accurate residual + ds-accumulated solution
            from riskaversetrajopt_tpu.ops import dsjit as dsa

            sh, sl = sol, jnp.zeros_like(sol)
            for _ in range(cfg.kkt_ds_refine_iters):
                kh, kl = dsa.dot2(K, sh)
                kl = kl + K @ sl
                rh, rl = dsa.ds_add(
                    rhs_full, jnp.zeros_like(rhs_full), -kh, -kl
                )
                corr = lu_apply(rh + rl)
                sh, sl = dsa.ds_add(sh, sl, corr, jnp.zeros_like(corr))
            return sh + sl

        # fraction-to-boundary
        tau_ftb = jnp.maximum(cfg.tau_min, 1.0 - s.mu)

        def max_step(vv, dv, mask):
            ratio = jnp.where(
                mask & (dv < 0), -vv / jnp.where(dv < 0, dv, -1.0), jnp.inf
            )
            return jnp.minimum(1.0, tau_ftb * jnp.min(ratio, initial=jnp.inf))

        def mk_dirs(sol_aug):
            """Full direction bundle from an augmented-KKT solution."""
            dZ = sol_aug[:n]
            dy_eq = sol_aug[n : n + n_eq]
            JdZ = J_in @ dZ
            ds_l = jnp.where(has_l, JdZ + r_l, 0.0)
            ds_u = jnp.where(has_u, r_u - JdZ, 0.0)
            dlam_l = jnp.where(has_l, -(r_cl + s.lam_l * ds_l) / s.s_l, 0.0)
            dlam_u = jnp.where(has_u, -(r_cu + s.lam_u * ds_u) / s.s_u, 0.0)
            a_p_max = jnp.minimum(
                max_step(s.s_l, ds_l, has_l), max_step(s.s_u, ds_u, has_u)
            )
            if cfg.damp_iters > 0:
                # first-steps damping (see NLPConfig.damp_iters)
                a_p_max = jnp.where(
                    s.it < cfg.damp_iters,
                    jnp.minimum(a_p_max, cfg.damp_max),
                    a_p_max,
                )
            a_d = jnp.minimum(
                max_step(s.lam_l, dlam_l, has_l),
                max_step(s.lam_u, dlam_u, has_u),
            )
            return (dZ, dy_eq, ds_l, ds_u, dlam_l, dlam_u, a_p_max, a_d)

        dirs = mk_dirs(solve_kkt(jnp.concatenate([-r_d, rhs_rows])))
        dZ, dy_eq, ds_l, ds_u, dlam_l, dlam_u, a_p_max, a_d = dirs

        # penalty update: nu must dominate the multipliers (guarded so a
        # non-finite trial direction cannot poison the penalty permanently)
        lam_norm = jnp.maximum(
            jnp.max(jnp.abs(dy_eq + s.y_eq), initial=0.0),
            jnp.maximum(jnp.max(jnp.abs(s.lam_l + dlam_l)), jnp.max(jnp.abs(s.lam_u + dlam_u))),
        )
        nu = jnp.where(
            jnp.isfinite(lam_norm),
            jnp.maximum(s.nu, cfg.nu_margin * lam_norm),
            s.nu,
        )

        # backtracking Armijo on the merit
        phi0, theta0 = merit(s.Z, s.s_l, s.s_u, s.mu, nu)

        def try_alpha(a, dZ_, ds_l_, ds_u_):
            Zt = s.Z + a * dZ_
            slt = s.s_l + a * ds_l_
            sut = s.s_u + a * ds_u_
            phi, theta = merit(Zt, slt, sut, s.mu, nu)
            finite = jnp.isfinite(phi[0])
            # accept on merit decrease or violation decrease; the decrement
            # is formed as a DIFFERENCE so the compensated mode can resolve
            # it below the f32 resolution of the merit magnitudes
            if cfg.merit_compensated:
                from riskaversetrajopt_tpu.ops import dsjit as ds

                dh, _ = ds.ds_add(phi[0], phi[1], -phi0[0], -phi0[1])
            else:
                dh = phi[0] - phi0[0]
            ok = finite & (
                (dh <= -1e-8 * a * jnp.abs(phi0[0]))
                | (theta <= 0.99 * theta0)
            )
            return ok

        ok0 = try_alpha(a_p_max, dZ, ds_l, ds_u)

        if cfg.soc:
            # Second-order correction (see NLPConfig.soc): one extra
            # constraint evaluation at the rejected trial point + one LU
            # back-substitution on the SAME factorization. Taken only if the
            # corrected full step itself passes the line search; otherwise
            # the original direction proceeds to backtracking.
            def with_soc():
                Zt = s.Z + a_p_max * dZ
                ct = c_fn(Zt)
                r_eq_soc = a_p_max * r_eq + (ct[:n_eq] - b_eq)
                rhs2 = jnp.concatenate([-r_d, -r_eq_soc, v / D_safe])
                d2 = mk_dirs(solve_kkt(rhs2))
                ok2 = try_alpha(d2[6], d2[0], d2[2], d2[3])
                chosen = jax.tree.map(
                    lambda a_, b_: jnp.where(ok2, a_, b_), d2, dirs
                )
                return chosen, ok2

            (dirs_c, soc_taken) = lax.cond(
                ok0, lambda: (dirs, jnp.asarray(False)), with_soc
            )
            dZ, dy_eq, ds_l, ds_u, dlam_l, dlam_u, a_p_max, a_d = dirs_c
            ok0 = ok0 | soc_taken

        def bt_cond(carry):
            a, ok, k = carry
            return jnp.logical_not(ok) & (k < cfg.max_backtracks)

        def bt_step(carry):
            a, ok, k = carry
            a_try = a * 0.5
            return (a_try, try_alpha(a_try, dZ, ds_l, ds_u), k + 1)

        a_p, ok, n_bt = lax.while_loop(bt_cond, bt_step, (a_p_max, ok0, 0))

        Z_new = s.Z + a_p * dZ
        s_l_new = jnp.where(has_l, s.s_l + a_p * ds_l, 1.0)
        s_u_new = jnp.where(has_u, s.s_u + a_p * ds_u, 1.0)
        lam_l_new = jnp.where(has_l, s.lam_l + a_d * dlam_l, 0.0)
        lam_u_new = jnp.where(has_u, s.lam_u + a_d * dlam_u, 0.0)
        y_eq_new = s.y_eq + a_d * (dy_eq if n_eq > 0 else 0.0)

        # IPOPT kappa_sigma multiplier safeguard (IPOPT eq. 16): keep each
        # bound multiplier within a factor kappa_sigma of mu/s so duals
        # cannot run away from the primal iterates
        k_sig = 1e10
        lam_l_new = jnp.where(
            has_l,
            jnp.clip(
                lam_l_new, s.mu / (k_sig * s_l_new), k_sig * s.mu / s_l_new
            ),
            0.0,
        )
        lam_u_new = jnp.where(
            has_u,
            jnp.clip(
                lam_u_new, s.mu / (k_sig * s_u_new), k_sig * s.mu / s_u_new
            ),
            0.0,
        )

        # reject entirely if line search failed: raise regularization instead
        step_ok = ok
        pick = lambda new, old: jnp.where(step_ok, new, old)
        Z_new = pick(Z_new, s.Z)
        s_l_new = pick(s_l_new, s.s_l)
        s_u_new = pick(s_u_new, s.s_u)
        lam_l_new = pick(lam_l_new, s.lam_l)
        lam_u_new = pick(lam_u_new, s.lam_u)
        y_eq_new = pick(y_eq_new, s.y_eq)
        tau_reg = jnp.where(
            step_ok,
            jnp.maximum(tau_used / 3.0, cfg.tau_reg_init),
            jnp.minimum(jnp.maximum(tau_used * 10.0, 1e-6), cfg.tau_reg_max),
        )

        _, _, _, _, _, _, prim_n, dual_n, comp_n = kkt_errors(
            Z_new, y_eq_new, s_l_new, s_u_new, lam_l_new, lam_u_new, s.mu
        )
        err_mu = jnp.maximum(prim_n, jnp.maximum(dual_n, comp_n))
        if cfg.mu_strategy == "loqo":
            # LOQO adaptive rule (IPOPT mu_oracle=loqo): mu follows the
            # iterate's actual complementarity, with extra centering when the
            # products are unbalanced
            prods = jnp.concatenate(
                [
                    jnp.where(has_l, s_l_new * lam_l_new, jnp.nan),
                    jnp.where(has_u, s_u_new * lam_u_new, jnp.nan),
                ]
            )
            avg = jnp.nanmean(prods)
            xi = jnp.nanmin(prods) / jnp.maximum(avg, 1e-300)
            sigma_c = 0.1 * jnp.minimum(0.05 * (1.0 - xi) / jnp.maximum(xi, 1e-6), 2.0) ** 3
            mu_new = jnp.clip(sigma_c * avg, cfg.tol / 10.0, 1e2)
        else:
            # monotone Fiacco-McCormick (IPOPT eq. 7)
            mu_new = jnp.where(
                err_mu <= cfg.kappa_eps * s.mu,
                jnp.maximum(
                    cfg.tol / 10.0,
                    jnp.minimum(cfg.kappa_mu * s.mu, s.mu**cfg.theta_mu),
                ),
                s.mu,
            )
        mu_new = jnp.where(jnp.isfinite(mu_new), mu_new, s.mu)

        # overall convergence at mu -> 0: errors with mu=0 complementarity
        _, _, _, _, _, _, prim0, dual0, comp0 = kkt_errors(
            Z_new, y_eq_new, s_l_new, s_u_new, lam_l_new, lam_u_new, 0.0
        )
        done = (
            (jnp.maximum(prim0, jnp.maximum(dual0, comp0)) <= cfg.tol)
            | jnp.logical_not(jnp.isfinite(err_mu))
        )

        return _S(
            Z=Z_new,
            y_eq=y_eq_new,
            s_l=s_l_new,
            s_u=s_u_new,
            lam_l=lam_l_new,
            lam_u=lam_u_new,
            mu=mu_new,
            tau_reg=tau_reg,
            nu=nu,
            it=s.it + 1,
            prim=prim0,
            dual=dual0,
            comp=comp0,
            done=done,
            a_p=a_p,
            ok=step_ok,
            d_tau_used=tau_used,
            d_maxD=jnp.max(D),
            d_minsl=jnp.min(jnp.where(has_l, s.s_l, jnp.inf)),
            d_dynorm=jnp.max(jnp.abs(dy_eq), initial=0.0),
            d_theta=theta0,
        )

    def cond(s: _S):
        return jnp.logical_not(s.done) & (s.it < cfg.max_iter)

    init = _S(
        Z=Z_init,
        y_eq=jnp.zeros(n_eq, dtype),
        s_l=s_l0,
        s_u=s_u0,
        lam_l=lam_l_init,
        lam_u=lam_u_init,
        mu=jnp.asarray(cfg.mu_init, dtype),
        tau_reg=jnp.asarray(cfg.tau_reg_init, dtype),
        nu=jnp.asarray(cfg.nu_init, dtype),
        it=jnp.zeros((), jnp.int32),
        prim=jnp.asarray(jnp.inf, dtype),
        dual=jnp.asarray(jnp.inf, dtype),
        comp=jnp.asarray(jnp.inf, dtype),
        done=jnp.asarray(False),
        a_p=jnp.zeros((), dtype),
        ok=jnp.asarray(True),
        d_tau_used=jnp.zeros((), dtype),
        d_maxD=jnp.zeros((), dtype),
        d_minsl=jnp.zeros((), dtype),
        d_dynorm=jnp.zeros((), dtype),
        d_theta=jnp.zeros((), dtype),
    )
    if trace_iters:
        def scan_body(s, _):
            s2 = lax.cond(s.done, lambda: s, lambda: body(s))
            diag = (s2.prim, s2.dual, s2.comp, s2.mu, s2.tau_reg, s2.nu,
                    s2.a_p, s2.ok, s2.d_tau_used, s2.d_maxD, s2.d_minsl,
                    s2.d_dynorm, s2.d_theta)
            return s2, diag
        s, trace = lax.scan(scan_body, init, None, length=trace_iters)
        solve_nlp.last_trace = jax.tree.map(lambda x: x, trace)
    else:
        s = lax.while_loop(cond, body, init)

    return NLPResult(
        Z=s.Z,
        y_eq=s.y_eq,
        lam_l=s.lam_l,
        lam_u=s.lam_u,
        iters=s.it,
        prim_res=s.prim,
        dual_res=s.dual,
        comp_res=s.comp,
        solved=(jnp.maximum(s.prim, jnp.maximum(s.dual, s.comp)) <= cfg.tol),
        f_val=f_fn(s.Z),
    )
