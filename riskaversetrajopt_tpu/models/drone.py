"""Drone point-mass model with quadratic drag, state-feedback-corrected
control, uncertain mass and uncertain ellipsoidal obstacles.

Behavior parity with drone/drone_risk.py:122-213 and
drone/drone_utils.py:61-93 (sampling), re-designed as pure functions over an
explicit uncertainty pytree and scan-compatible step functions.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from riskaversetrajopt_tpu.core.config import DroneScenario
from riskaversetrajopt_tpu.models.base import ConstBind


class DroneOmega(NamedTuple):
    """Per-sample uncertain parameters (leading axis M when batched)."""

    mass: jnp.ndarray  # () or (M,)
    obs_Q: jnp.ndarray  # (n_obs, 3, 3) or (M, n_obs, 3, 3)
    dWs: jnp.ndarray  # (S, n_x) or (M, S, n_x) -- already scaled by sqrt(dt)


class DroneModel(ConstBind):
    """SAA drone model. Reference: drone/drone_risk.py Model (lines 70-213)."""

    # array constants that cross jit boundaries as arguments (see
    # models/base.ConstBind)
    const_attrs = ("_fb_gain", "_obs_positions", "_x_init", "_x_final")

    def __init__(self, scn: DroneScenario = DroneScenario()):
        self.scn = scn
        self.n_x = scn.n_x
        self.n_u = scn.n_u
        self.S = scn.S
        self.dt = scn.dt
        self.n_obs = scn.n_obs
        self.K = scn.n_obs * scn.S
        self.n_fc = scn.n_x
        # Conditioning multiplier applied to CVaR sample rows
        # (drone_risk.py:310,353 MULTIPLIER = 0.01).
        self.row_scale = 0.01
        # slack objective weight (drone_risk.py:388-390)
        self.slack_penalty = 10000.0
        self._fb_gain = scn.feedback_gain
        self._obs_positions = scn.obs_positions
        self._x_init = scn.x_init
        self._x_final = scn.x_final

    # -- dynamics ----------------------------------------------------------
    def drift(self, x, u, omega: DroneOmega):
        """b(x, u, mass): velocity kinematics + feedback-corrected thrust with
        |v|v drag (drone_risk.py:122-131)."""
        v = x[3:6]
        control_applied = u + self._fb_gain @ x
        acc = (control_applied - self.scn.drag_coefficient * jnp.abs(v) * v) / omega.mass
        return jnp.concatenate([v, acc])

    def dispersion(self, x, u, omega: DroneOmega, dW):
        """sigma(x, u, mass) @ dW with sigma = (beta/mass) I on the velocity
        block (drone_risk.py:133-137), in matvec form."""
        scale = self.scn.beta / omega.mass
        return jnp.concatenate([jnp.zeros(3, dtype=x.dtype), scale * dW[3:6]])

    def x0(self, omega: DroneOmega):
        return self._x_init

    # -- constraints -------------------------------------------------------
    def ineq_constraints(self, xs, omega: DroneOmega):
        """Obstacle-avoidance constraints g <= 0 for one sample, flattened
        obstacle-major: row j*S + t <-> obstacle j at step t+1.

        g_jt = 1 - (p_t - op_j)^T Q_j[:2,:2] (p_t - op_j)
        (2-D slice of the 3-D ellipsoid, drone_risk.py:169-213).
        xs: (S+1, n_x); returns (n_obs * S,).
        """
        p = xs[1:, :2]  # (S, 2)
        op = self._obs_positions[:, :2]  # (n_obs, 2)
        Q2 = omega.obs_Q[:, :2, :2]  # (n_obs, 2, 2)
        d = p[None, :, :] - op[:, None, :]  # (n_obs, S, 2)
        quad = jnp.einsum("jti,jik,jtk->jt", d, Q2, d)
        return (1.0 - quad).reshape(self.K)

    def ineq_constraints_euclidean(self, xs, omega: DroneOmega):
        """Euclidean (sqrt) obstacle-constraint variant used only for MC
        verification in the paper-figure workload
        (drone_main_plot.py:198-208): 1 - sqrt((p-op)^T Q (p-op))."""
        p = xs[1:, :2]
        op = self._obs_positions[:, :2]
        Q2 = omega.obs_Q[:, :2, :2]
        d = p[None, :, :] - op[:, None, :]
        quad = jnp.einsum("jti,jik,jtk->jt", d, Q2, d)
        return (1.0 - jnp.sqrt(quad)).reshape(self.K)

    def final_constraints(self, xs):
        """x_T - x_final (drone_risk.py:164-167)."""
        return xs[-1, :] - self._x_final

    # -- objective ---------------------------------------------------------
    def control_cost(self, us_mat):
        """dt * sum_t u_t^T R u_t (drone_risk.py:649-654 monte_carlo_cost)."""
        R = self.scn.R
        return self.dt * jnp.sum(jnp.einsum("ti,ij,tj->t", us_mat, R, us_mat))

    # -- sampling ----------------------------------------------------------
    def sample(self, key, M: int, method: str = "saa") -> DroneOmega:
        """Draw per-sample uncertainty, matching the reference distributions
        (drone_utils.py:61-93): uniform masses in [nom-delta, nom+delta],
        uniform per-axis obstacle-radius perturbations baked into diagonal
        Q = diag(1/length^2), Brownian increments sqrt(dt)*N(0, I).

        'baseline' zeroes all uncertainty (nominal mass, nominal radii,
        zero noise) exactly as drone_utils.py:77-92.
        """
        scn = self.scn
        k_mass, k_obs, k_dw = jax.random.split(key, 3)
        if method == "saa":
            masses = jax.random.uniform(
                k_mass, (M,), minval=scn.mass_nom - scn.mass_delta,
                maxval=scn.mass_nom + scn.mass_delta,
            )
            # one radius perturbation per (obstacle, axis) pair per sample
            deltas = jax.random.uniform(
                k_obs, (M, scn.n_obs, 3), minval=-scn.obs_radii_deltas,
                maxval=scn.obs_radii_deltas,
            )
            lengths = scn.obs_radii[None, :, None] + deltas
            q_diag = 1.0 / lengths**2  # (M, n_obs, 3)
            obs_Q = jax.vmap(jax.vmap(jnp.diag))(q_diag)  # (M, n_obs, 3, 3)
            dWs = jnp.sqrt(scn.dt) * jax.random.normal(k_dw, (M, scn.S, scn.n_x))
        elif method == "baseline":
            masses = scn.mass_nom * jnp.ones(M)
            q_diag = jnp.broadcast_to(
                (1.0 / scn.obs_radii**2)[None, :, None], (M, scn.n_obs, 3)
            )
            obs_Q = jax.vmap(jax.vmap(jnp.diag))(q_diag)
            dWs = jnp.zeros((M, scn.S, scn.n_x))
        else:
            raise ValueError(f"unknown sampling method: {method}")
        return DroneOmega(mass=masses, obs_Q=obs_Q, dWs=dWs)

    def default_scp_config(self):
        """Reference SCP knobs: 60 iterations (drone_risk.py:56), first 2
        iterations gated with row scale 1e-7 and bounds +/-0.1
        (drone_risk.py:413-417)."""
        from riskaversetrajopt_tpu.core.config import SCPConfig

        return SCPConfig(
            num_iters=60,
            gate_iters=2,
            gate_row_scale=1e-7,
            gate_bound_l=-0.1,
            gate_bound_u=0.1,
        )

    # -- initial guess -----------------------------------------------------
    def initial_guess(self):
        """Midpoint-of-bounds + 1e-2 on the first n_u-1 controls
        (drone_risk.py:108-120: only indices :(n_u-1) get the offset)."""
        us = jnp.zeros((self.S, self.n_u))
        return us.at[:, : self.n_u - 1].set(1e-2)
