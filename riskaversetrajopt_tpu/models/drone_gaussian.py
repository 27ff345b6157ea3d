"""Gaussian-linearization drone baseline solved as an NLP with optimal risk
allocation over (timestep, obstacle) pairs and obstacle radii.

Parity with drone/drone_gaussian.py: decision vector
Z = [us (S*n_u) | alphas_risk (S*n_obs + n_obs)] — per-(step,obstacle) state
risk plus per-obstacle radius risk; quantile-padded obstacle constraints with
radius back-off rad_max - (alpha_obs/3)(rad_max - rad_min)
(drone_gaussian.py:251-255); covariance propagated with the iid-mass
approximation (drone_gaussian.py:176-227); solved as one NLP
(IPOPT tol 1e-8 -> ops/nlp_ipm). The reference warm-starts from the SAA
solution of drone_risk.py (drone_gaussian.py:104-116) — pass that via
`us_init`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from riskaversetrajopt_tpu.core.config import DroneScenario
from riskaversetrajopt_tpu.models.base import ConstBind
from riskaversetrajopt_tpu.models.drone import DroneModel, DroneOmega
from riskaversetrajopt_tpu.ops.gaussian import normal_quantile, propagate_covariance
from riskaversetrajopt_tpu.ops.nlp_ipm import (
    NLPConfig,
    NLPResult,
    classify_rows,
    solve_nlp,
)


class GaussianDroneResult(NamedTuple):
    us: jnp.ndarray
    alphas_risk: jnp.ndarray
    xs: jnp.ndarray
    Sigmas: jnp.ndarray
    nlp: NLPResult


class GaussianDronePlanner(ConstBind):
    # array constants arg-rooted across jit boundaries (ConstBind rationale
    # in models/base and ops/nlp_ipm)
    const_attrs = (
        "_x_init", "_x_final", "_obs_positions", "_obs_radii", "_R",
        "_nominal_omega",
    )

    def __init__(self, scn: DroneScenario = DroneScenario(), alpha: float = 0.1,
                 dtype=jnp.float64):
        self.scn = scn
        self.alpha = alpha
        self.dtype = dtype
        self.drone = DroneModel(scn)
        self.S, self.n_x, self.n_u, self.n_obs = scn.S, scn.n_x, scn.n_u, scn.n_obs
        self.n_us = self.S * self.n_u
        self.n_alpha = self.S * self.n_obs + self.n_obs
        self.nv = self.n_us + self.n_alpha
        self.mass_var = (2 * scn.mass_delta) ** 2 / 12.0  # drone_gaussian.py:82
        self._x_init = scn.x_init
        self._x_final = scn.x_final
        self._obs_positions = scn.obs_positions
        self._obs_radii = scn.obs_radii
        self._R = scn.R
        self._nominal_omega = DroneOmega(
            mass=jnp.asarray(scn.mass_nom),
            obs_Q=jnp.zeros((scn.n_obs, 3, 3)),
            dWs=jnp.zeros((scn.S, scn.n_x)),
        )
        # pin array constants to the planner dtype: under a CPU-x64
        # session an f32 planner would otherwise carry f64 constants into
        # the NLP callbacks and break the barrier-loop carry typing (same
        # hardening as GaussianCarPlanner)
        for a in self.const_attrs:
            setattr(
                self, a,
                jax.tree.map(
                    lambda v: jnp.asarray(v, dtype), getattr(self, a)
                ),
            )

    def consts(self):
        d = super().consts()
        d["_drone"] = self.drone.consts()
        return d

    def bind(self, consts):
        m = super().bind({k: v for k, v in consts.items() if k != "_drone"})
        m.drone = self.drone.bind(consts["_drone"])
        return m

    def split_z(self, Z):
        us = Z[: self.n_us].reshape(self.S, self.n_u)
        alphas = Z[self.n_us :]
        # alphas_risk_state stored obstacle-major then transposed, matching
        # reshape((n_obs, S), 'F').T at drone_gaussian.py:358-359
        a_state = alphas[: self.S * self.n_obs].reshape(self.S, self.n_obs)
        a_obs = alphas[self.S * self.n_obs :]
        return us, a_state, a_obs

    # -- mean + covariance (drone_gaussian.py:161-227) ---------------------
    def mean_trajectory(self, us_mat):
        om = self._nominal_omega

        def step(x, u):
            xn = x + self.scn.dt * self.drone.drift(x, u, om)
            return xn, xn

        x0 = self._x_init.astype(us_mat.dtype)
        _, xs_tail = jax.lax.scan(step, x0, us_mat)
        return jnp.concatenate([x0[None], xs_tail], axis=0)

    def covariance_trajectory(self, us_mat):
        om = self._nominal_omega
        drift = lambda x, u, mass: self.drone.drift(
            x, u, om._replace(mass=mass)
        )
        dj_x = lambda x, u: jax.jacfwd(drift, 0)(x, u, om.mass)
        dj_m = lambda x, u: jax.jacfwd(drift, 2)(x, u, om.mass)

        def disp(x, u):
            sig = jnp.zeros((self.n_x, self.n_x), us_mat.dtype)
            return sig.at[3:6, 3:6].set(
                (self.scn.beta / self.scn.mass_nom) * jnp.eye(3, dtype=us_mat.dtype)
            )

        Sigma0 = jnp.zeros((self.n_x, self.n_x), us_mat.dtype)
        return propagate_covariance(
            self.mean_trajectory(us_mat), us_mat, Sigma0, dj_x, disp,
            [dj_m], [self.mass_var], self.scn.dt,
        )

    # -- constraints -------------------------------------------------------
    def obstacle_constraints(self, us_mat, a_state, a_obs):
        """(n_obs, S) quantile-padded obstacle rows
        (drone_gaussian.py:238-316): g = -(dist - pad - radius_backoff)."""
        xs = self.mean_trajectory(us_mat)
        Sigmas = self.covariance_trajectory(us_mat)
        scn = self.scn

        def one(mu, Sigma, a_s, a_o, obs_p, obs_r):
            p = mu[:2]
            Sig = Sigma[:2, :2]
            rad_min = obs_r - scn.obs_radii_deltas
            rad_max = obs_r + scn.obs_radii_deltas
            radius = rad_max - (a_o / 3.0) * (rad_max - rad_min)
            delta = p - obs_p[:2]
            dist = jnp.linalg.norm(delta)
            normal = delta / dist
            # clamp: the position variance is exactly zero at t=1 (Sigma_0 = 0
            # and the first step only adds velocity noise), and sqrt has an
            # infinite derivative at 0 which would poison jacfwd; the clamp
            # changes the padding by < ndtri(1-a)*1e-6
            var = jnp.maximum(normal @ Sig @ normal, 1e-12)
            pad = normal_quantile(1 - a_s) * jnp.sqrt(var)
            return -(dist - pad - radius)

        def per_obstacle(j):
            return jax.vmap(
                lambda t: one(
                    xs[t + 1], Sigmas[t + 1], a_state[t, j], a_obs[j],
                    self._obs_positions[j], self._obs_radii[j],
                )
            )(jnp.arange(self.S))

        return jax.vmap(per_obstacle)(jnp.arange(self.n_obs))  # (n_obs, S)

    def state_bound_constraints(self, us_mat):
        """xs[:, :2] box rows (drone_gaussian.py:368-374). Bounds enter as
        scalar literals (no baked array constants — see const_attrs note)."""
        xs = self.mean_trajectory(us_mat)
        hi = (xs[:, :2] - 0.5).reshape(-1)
        lo = jnp.stack([-xs[:, 0] - 2.0, -xs[:, 1] - 0.5], axis=-1).reshape(-1)
        return jnp.concatenate([hi, lo])

    # -- NLP assembly (drone_gaussian.py:400-526) --------------------------
    def f(self, Z):
        us, _, _ = self.split_z(Z)
        R = self._R
        return 2.0 * self.scn.dt * jnp.sum(jnp.einsum("ti,ij,tj->t", us, R, us))

    def g(self, Z):
        us, a_state, a_obs = self.split_z(Z)
        g_final = self.mean_trajectory(us)[-1] - self._x_final
        g_obs = self.obstacle_constraints(us, a_state, a_obs).reshape(-1)
        g_sb = self.state_bound_constraints(us)
        alphas = Z[self.n_us :]
        g_ctrl = jnp.concatenate([Z[: self.n_us], alphas, jnp.sum(alphas)[None]])
        return jnp.concatenate([g_final, g_obs, g_sb, g_ctrl])

    def bounds(self):
        scn = self.scn
        big = 1e15
        n_eq = self.n_x
        m_obs = self.n_obs * self.S + 4 * (self.S + 1)
        gL = [jnp.zeros(n_eq), jnp.full(m_obs, -big)]
        gU = [jnp.zeros(n_eq), jnp.zeros(m_obs)]
        # control bounds; alpha in [1e-6, alpha]; sum alpha in [0, alpha]
        gL.append(jnp.full(self.n_us, -scn.u_max))
        gU.append(jnp.full(self.n_us, scn.u_max))
        gL.append(jnp.full(self.n_alpha, 1e-6))
        gU.append(jnp.full(self.n_alpha, self.alpha))
        gL.append(jnp.zeros(1))
        gU.append(jnp.full(1, self.alpha))
        g_L = jnp.concatenate(gL).astype(self.dtype)
        g_U = jnp.concatenate(gU).astype(self.dtype)
        x_L = jnp.full(self.nv, -1000.0, self.dtype)
        x_U = jnp.full(self.nv, 1000.0, self.dtype)
        return g_L, g_U, n_eq, x_L, x_U

    def initial_guess(self, us_init: Optional[jnp.ndarray] = None):
        """Reference: SAA solution as us warm start (drone_gaussian.py:104-116)
        + uniform risk allocation (drone_gaussian.py:118-124)."""
        Z = jnp.zeros(self.nv, self.dtype)
        if us_init is not None:
            Z = Z.at[: self.n_us].set(us_init.reshape(-1).astype(self.dtype))
        a0 = self.alpha / (self.S * self.n_obs + self.n_obs)
        return Z.at[self.n_us :].set(a0)

    def solve(
        self, us_init: Optional[jnp.ndarray] = None,
        cfg: Optional[NLPConfig] = None, jitted: bool = False,
    ) -> GaussianDroneResult:
        # ~500 barrier iterations are required from the SAA warm start (the
        # round-1 "dual plateau at 0.4" was an under-budgeted run: at
        # max_iter=1000 the solve converges to prim 2e-11 / dual 3e-7);
        # the reference runs IPOPT with max_iter 3000 (drone_gaussian.py:
        # 500-502). f32 default adds symmetric KKT equilibration
        # (NLPConfig.kkt_ruiz_iters — the augmented KKT's conditioning
        # exceeds 1/eps_f32 raw; same hardening as the hopper, PARITY.md)
        if cfg is None:
            f32 = jnp.dtype(self.dtype) == jnp.float32
            cfg = NLPConfig(tol=1e-6, max_iter=1500,
                            kkt_ruiz_iters=3 if f32 else 0)
        g_L, g_U, n_eq, x_L, x_U = self.bounds()
        Z0 = self.initial_guess(us_init)
        if jitted:
            # arg-rooted path for accelerators: problem arrays travel as jit
            # arguments via the params pytree (ops/nlp_ipm solve_nlp notes)
            row_perm = classify_rows(g_L, g_U, n_eq)
            f_fn = lambda Z, p: self.bind(p).f(Z)  # noqa: E731
            g_fn = lambda Z, p: self.bind(p).g(Z)  # noqa: E731
            res = jax.jit(
                lambda Z0, params, gL, gU, xL, xU: solve_nlp(
                    f_fn, g_fn, gL, gU, n_eq, xL, xU, Z0, cfg,
                    params=params, row_perm=row_perm,
                )
            )(Z0, self.consts(), g_L, g_U, x_L, x_U)
        else:
            res = solve_nlp(self.f, self.g, g_L, g_U, n_eq, x_L, x_U, Z0, cfg)
        us, a_state, a_obs = self.split_z(res.Z)
        return GaussianDroneResult(
            us=us,
            alphas_risk=res.Z[self.n_us :],
            xs=self.mean_trajectory(us),
            Sigmas=self.covariance_trajectory(us),
            nlp=res,
        )
