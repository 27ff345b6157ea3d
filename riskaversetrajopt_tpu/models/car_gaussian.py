"""Gaussian-linearization car baseline with optimal risk allocation.

Parity with car/driving_gaussian.py: propagate the pedestrian-state mean and
covariance through the linearized social-force dynamics, impose the separation
constraint as a quantile back-off with PER-STEP risk-allocation variables
alpha_t that are themselves QP decision variables (bounds
100*OSQP_TOL <= alpha_t <= alpha, sum_t alpha_t <= alpha,
driving_gaussian.py:271-301), and run SCP with a dense QP per iteration
(variables z = [us | alphas_risk | one unused trailing column — the reference
allocates it as a slack that never enters any constraint or objective,
driving_gaussian.py:363-366; reproduced for layout parity]).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from riskaversetrajopt_tpu.core.config import CarScenario, SolverConfig
from riskaversetrajopt_tpu.models.base import ConstBind
from riskaversetrajopt_tpu.models.car import CarModel, CarOmega
from riskaversetrajopt_tpu.ops import admm
from riskaversetrajopt_tpu.ops.gaussian import normal_quantile, propagate_covariance
from riskaversetrajopt_tpu.ops.ipm import IPMConfig, solve_qp_ipm


class GaussianCarResult(NamedTuple):
    us: jnp.ndarray  # (S, n_u)
    alphas_risk: jnp.ndarray  # (S,)
    xs: jnp.ndarray  # (S+1, n_x) mean trajectory
    Sigmas: jnp.ndarray  # (S+1, n_x, n_x)
    l2_errors: jnp.ndarray
    # per-SCP-iteration QP certification flags (admm-ir backend certifies
    # the OSQP_TOL=1e-8 stress tolerance with compensated residuals; the
    # ipm backend reports its own convergence flag)
    qp_solved: jnp.ndarray = None


class GaussianCarPlanner(ConstBind):
    OSQP_TOL = 1e-8  # reference override (driving_gaussian.py:27)
    # array constants arg-rooted across jit boundaries (models/base.ConstBind)
    # — see solve_jitted
    const_attrs = ("Sigma0", "_nominal_omega", "_state_init", "_goal",
                   "_R_diag")

    def __init__(self, scn: CarScenario = CarScenario(), alpha: float = 0.1,
                 num_scp_iters: int = 60, dtype=jnp.float64):
        self.scn = scn
        self.alpha = alpha
        self.num_scp_iters = num_scp_iters
        self.dtype = dtype
        self.car = CarModel(scn)
        self.S, self.n_x, self.n_u = scn.S, scn.n_x, scn.n_u
        self.nv = self.n_u * self.S + self.S + 1
        # uniform-distribution variances of the interaction gains
        # (driving_gaussian.py:81-84)
        self.var_speed = (2 * scn.omega_speed_del) ** 2 / 12.0
        self.var_rep = (2 * scn.omega_repulsive_del) ** 2 / 12.0
        self.Sigma0 = jnp.zeros((scn.n_x, scn.n_x)).at[4:, 4:].set(
            scn.variance_ped_initial_state
        )
        self._state_init = scn.state_init
        self._goal = jnp.concatenate(
            (scn.position_ego_goal, scn.velocity_ego_goal)
        )
        self._R_diag = jnp.diag(scn.R)
        self._nominal_omega = CarOmega(
            state_init=scn.state_init,
            omega_speed=jnp.asarray(scn.omega_speed_nom),
            omega_repulsive=jnp.asarray(scn.omega_repulsive_nom),
            dWs=jnp.zeros((scn.S, scn.n_x)),
        )
        # pin every array constant to the planner dtype: under a CPU-x64
        # session an f32 planner would otherwise carry f64 constants into
        # the QP operators and break the IPM while-loop carry typing
        for a in self.const_attrs:
            setattr(
                self, a,
                jax.tree.map(
                    lambda v: jnp.asarray(v, dtype), getattr(self, a)
                ),
            )

    # -- mean + covariance propagation (driving_gaussian.py:171-228) -------
    def mean_trajectory(self, us_mat):
        om = self._nominal_omega

        def step(x, u):
            xn = x + self.scn.dt * self.car.drift(x, u, om)
            return xn, xn

        x0 = self._state_init.astype(us_mat.dtype)
        _, xs_tail = jax.lax.scan(step, x0, us_mat)
        return jnp.concatenate([x0[None], xs_tail], axis=0)

    def covariance_trajectory(self, us_mat):
        om = self._nominal_omega
        xs = self.mean_trajectory(us_mat)
        drift = lambda x, u, os, orp: self.car.drift(
            x, u, om._replace(omega_speed=os, omega_repulsive=orp)
        )
        dj_x = lambda x, u: jax.jacfwd(drift, 0)(
            x, u, om.omega_speed, om.omega_repulsive
        )
        dj_s = lambda x, u: jax.jacfwd(drift, 2)(
            x, u, om.omega_speed, om.omega_repulsive
        )
        dj_r = lambda x, u: jax.jacfwd(drift, 3)(
            x, u, om.omega_speed, om.omega_repulsive
        )

        def disp(x, u):
            sig = jnp.zeros((self.n_x, self.n_x), us_mat.dtype)
            return sig.at[6:, 6:].set(self.scn.beta * jnp.eye(2, dtype=us_mat.dtype))

        return propagate_covariance(
            xs, us_mat, self.Sigma0.astype(us_mat.dtype), dj_x, disp,
            [dj_s, dj_r], [self.var_speed, self.var_rep], self.scn.dt,
        )

    # -- constraints -------------------------------------------------------
    def separation_constraints(self, us_mat, alphas_risk):
        """-(quantile-padded separation distances) at t = 1..S
        (driving_gaussian.py:237-264)."""
        xs = self.mean_trajectory(us_mat)
        Sigmas = self.covariance_trajectory(us_mat)

        def one(mu, Sigma, a_t):
            Sig_p = Sigma[4:6, 4:6]
            delta = mu[0:2] - mu[4:6]
            dist = jnp.linalg.norm(delta)
            normal = delta / dist
            # clamp guards the sqrt derivative at zero variance (see
            # drone_gaussian.py); padding change < ndtri(1-a)*1e-6
            var = jnp.maximum(normal @ Sig_p @ normal, 1e-12)
            pad = normal_quantile(1 - a_t) * jnp.sqrt(var)
            return -(dist - pad - self.scn.min_separation_distance)

        return jax.vmap(one)(xs[1:], Sigmas[1:], alphas_risk)

    def final_constraints(self, us_mat):
        xs = self.mean_trajectory(us_mat)
        return xs[-1, :4] - self._goal

    # -- QP assembly (driving_gaussian.py:271-426) --------------------------
    def build_qp(self, us_prev, alphas_prev, scp_iter):
        S, n_u, n_x = self.S, self.n_u, self.n_x
        nv = self.nv
        dtype = us_prev.dtype

        def cons(us_mat, alphas):
            return self.final_constraints(us_mat), self.separation_constraints(
                us_mat, alphas
            )

        (v_final, g_obs), = (cons(us_prev, alphas_prev),)
        jac_u = jax.jacfwd(cons, 0)(us_prev, alphas_prev)
        jac_a = jax.jacfwd(cons, 1)(us_prev, alphas_prev)
        F_u = jac_u[0].reshape(4, n_u * S)
        G_u = jac_u[1].reshape(S, n_u * S)
        F_a = jac_a[0]
        G_a = jac_a[1]

        us_vec = us_prev.reshape(-1)
        f_rhs = -v_final + F_u @ us_vec  # F_a = 0 but keep general
        f_rhs = f_rhs + F_a @ alphas_prev
        g_up = -g_obs + G_u @ us_vec + G_a @ alphas_prev

        inf = jnp.asarray(jnp.inf, dtype)
        # [final(4) | obs(S)] block with iteration gating on rows >= n_x
        A_top = jnp.zeros((4 + S, nv), dtype)
        A_top = A_top.at[:4, : n_u * S].set(F_u)
        A_top = A_top.at[:4, n_u * S : n_u * S + S].set(F_a)
        A_top = A_top.at[4:, : n_u * S].set(G_u)
        A_top = A_top.at[4:, n_u * S : n_u * S + S].set(G_a)
        l_top = jnp.concatenate([f_rhs, -inf * jnp.ones(S, dtype)])
        u_top = jnp.concatenate([f_rhs, g_up])

        gating = scp_iter < 1
        row_idx = jnp.arange(4 + S)
        gate_mask = gating & (row_idx >= n_x)
        A_top = jnp.where(gate_mask[:, None], 0.0, A_top)
        # reference: ls *= 0 on -inf -> NaN -> OSQP treats as -inf;
        # us *= 0 -> 0 (all finite there)
        l_top = jnp.where(gate_mask, -inf, l_top)
        u_top = jnp.where(gate_mask, 0.0, u_top)

        # control + risk-allocation rows (driving_gaussian.py:271-301)
        A_cr = jnp.zeros((n_u * S + S + 1, nv), dtype)
        A_cr = A_cr.at[: n_u * S, : n_u * S].set(jnp.eye(n_u * S, dtype=dtype))
        A_cr = A_cr.at[n_u * S : n_u * S + S, n_u * S : n_u * S + S].set(
            jnp.eye(S, dtype=dtype)
        )
        A_cr = A_cr.at[-1, n_u * S : n_u * S + S].set(1.0)
        lo_alpha = 100 * self.OSQP_TOL
        l_cr = jnp.concatenate(
            [
                jnp.full(n_u * S, -self.scn.u_max, dtype),
                jnp.full(S, lo_alpha, dtype),
                jnp.asarray([lo_alpha], dtype),
            ]
        )
        u_cr = jnp.concatenate(
            [
                jnp.full(n_u * S, self.scn.u_max, dtype),
                jnp.full(S, self.alpha, dtype),
                jnp.asarray([self.alpha], dtype),
            ]
        )

        A = jnp.concatenate([A_top, A_cr], axis=0)
        l = jnp.concatenate([l_top, l_cr])
        u = jnp.concatenate([u_top, u_cr])

        P = jnp.zeros((nv, nv), dtype)
        p_u = jnp.tile(2.0 * self.scn.dt * self._R_diag, S)
        P = P.at[jnp.arange(n_u * S), jnp.arange(n_u * S)].set(p_u.astype(dtype))
        q = jnp.zeros(nv, dtype)
        return P, q, A, l, u

    def initial_guess(self):
        us = jnp.full((self.S, self.n_u), 1e-2, self.dtype)
        alphas = (self.alpha / self.S) * jnp.ones(self.S, self.dtype)
        return us, alphas

    # -- SCP loop (driving_gaussian.py:466-499) ----------------------------
    def solve(self, ipm_cfg: IPMConfig = None,
              qp_backend: str = None) -> GaussianCarResult:
        """Full SCP solve. qp_backend: 'ipm' (x64 default — Mehrotra at
        tol 1e-7) or 'admm-ir' (f32 default — warm-started dense ADMM +
        compensated iterative refinement certifying the reference's
        OSQP_TOL=1e-8 stress tolerance, car/driving_gaussian.py:27, from
        f32-only arithmetic; plain f32 IPM diverges on these QPs)."""
        if qp_backend is None:
            qp_backend = (
                "admm-ir" if self.dtype == jnp.float32 else "ipm"
            )
        ipm_cfg = ipm_cfg or IPMConfig(tol=1e-7, max_iter=50)
        S, n_u = self.S, self.n_u
        nv = self.nv

        if qp_backend == "admm-ir":
            from riskaversetrajopt_tpu.ops.qp_refine import (
                IRConfig,
                solve_dense_qp_ir,
            )

            ir_solver_cfg = SolverConfig(
                eps_abs=1e-8, eps_rel=1e-8, max_iter=20000,
                polish=False, kkt_refine_iters=1,
            )

        def step(carry, scp_iter):
            us_prev, alphas_prev, wx, wy = carry
            P, q, A, l, u = self.build_qp(us_prev, alphas_prev, scp_iter)
            if qp_backend == "admm-ir":
                sol = solve_dense_qp_ir(
                    P, q, A, l, u, ir_solver_cfg, IRConfig(rounds=10, work_eps=1e-5),
                    x0=wx, y0=wy,
                )
            else:
                ops = admm.DenseQPOps(P, A)
                sol = solve_qp_ipm(ops, q, l, u, n_eq=4, cfg=ipm_cfg)
            us = sol.x[: n_u * S].reshape(S, n_u)
            alphas = sol.x[n_u * S : n_u * S + S]
            from riskaversetrajopt_tpu.scp.driver import l2_error_us

            l2 = l2_error_us(us, us_prev)
            return (us, alphas, sol.x, sol.y), (l2, sol.solved)

        us0, alphas0 = self.initial_guess()
        # build_qp row count: A_top (4 + S) + A_cr (n_u*S + S + 1)
        m_rows = 4 + S + n_u * S + S + 1
        wx0 = jnp.zeros(nv, self.dtype)
        wy0 = jnp.zeros(m_rows, self.dtype)
        (us, alphas, _, _), (l2s, solved) = jax.lax.scan(
            step, (us0, alphas0, wx0, wy0), jnp.arange(self.num_scp_iters)
        )
        xs = self.mean_trajectory(us)
        Sigmas = self.covariance_trajectory(us)
        return GaussianCarResult(
            us=us, alphas_risk=alphas, xs=xs, Sigmas=Sigmas, l2_errors=l2s,
            qp_solved=solved,
        )

    def solve_jitted(self, ipm_cfg: IPMConfig = None) -> GaussianCarResult:
        """`solve` with the planner's array constants passed as jit
        ARGUMENTS (ConstBind) instead of closure-baked constants — the
        accelerator entry point. Numerically identical to jit(self.solve)."""
        return jax.jit(lambda c: self.bind(c).solve(ipm_cfg))(self.consts())
