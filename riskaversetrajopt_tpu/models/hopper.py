"""2-D single-leg hopper: contact-implicit direct transcription with a
random-Fourier-feature friction field and no-slip CVaR constraints.

Behavior parity with hopper/hopper.py:43-453 (reference dynamics credited
there to dojo-sim/ContactImplicitMPC.jl). The decision vector and constraint
stack reproduce the reference layout exactly:

  Z = [xs ((S+1)*n_x, time-major) | us (S*n_u) | ys (M) | slack | t_risk]

  g(Z) = [dyn RK4 defects | x0 | xf | no-slip eq | contact eq      <- equalities
          | flight clearance | slip-CVaR rows | control rows
          | slack row | length/speed/omega rows]

with the equality families first — the contract required by the NLP solver's
equality-prefix Schur elimination (ops/nlp_ipm.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from riskaversetrajopt_tpu.core.config import HopperScenario
from riskaversetrajopt_tpu.models.base import ConstBind


class FrictionField(NamedTuple):
    """Random-Fourier-feature friction field samples (leading axis M):
    mu(px) = mu_nom + sum_j intensity_j * cos(theta_j * px + tau_j)
    (hopper/hopper.py:69-81)."""

    intensities: jnp.ndarray  # (M, F)
    thetas: jnp.ndarray  # (M, F)
    taus: jnp.ndarray  # (M, F)


class HopperModel(ConstBind):
    const_attrs = ("_state_initial", "_state_final")

    def __init__(self, scn: HopperScenario = HopperScenario()):
        self.scn = scn
        s = scn
        self.n_x, self.n_u, self.S, self.M = s.n_x, s.n_u, s.S, s.M
        self.dt = s.dt
        self.num_vars = s.num_vars
        # contact schedule: stance [0, time_jump), flight [time_jump,
        # time_land), stance [time_land, S] (hopper.py:48-49)
        self.contact_x_idx = np.concatenate(
            [np.arange(0, s.time_jump), np.arange(s.time_land, s.S)]
        )  # indices into xs[0..S] used for slip rows (hopper.py:305-308: [:-1])
        self.contact_u_idx = np.concatenate(
            [np.arange(0, s.time_jump), np.arange(s.time_land, s.S)]
        )
        self.num_contacts = len(self.contact_u_idx)
        # equality-row schedule for contact/no-slip (over xs[0..S],
        # hopper.py:266-298: [:time_jump] and [time_land:] of S+1 entries)
        self.eq_phase_idx = np.concatenate(
            [np.arange(0, s.time_jump), np.arange(s.time_land, s.S + 1)]
        )
        self.flight_idx = np.arange(s.time_jump, s.time_land)
        # array-valued constants arg-rooted across jit boundaries
        # (models/base.ConstBind); the phase selections in g_all use STATIC
        # slices (time_jump/time_land are compile-time ints) rather than
        # constant-index gathers for the same reason
        self._state_initial = jnp.asarray(s.state_initial)
        self._state_final = jnp.asarray(s.state_final)

    # -- Z layout ----------------------------------------------------------
    def split_z(self, Z):
        s = self.scn
        nxs = (s.S + 1) * s.n_x
        nus = s.S * s.n_u
        xs = Z[:nxs].reshape(s.S + 1, s.n_x)
        us = Z[nxs : nxs + nus].reshape(s.S, s.n_u)
        ys = Z[nxs + nus : -2]
        slack = Z[-2]
        t_risk = Z[-1]
        return xs, us, ys, slack, t_risk

    # -- kinematics & manipulator terms (hopper.py:166-231) ----------------
    def end_effector_position(self, x):
        return jnp.array(
            [x[0] + x[3] * jnp.sin(x[2]), x[1] - x[3] * jnp.cos(x[2])]
        )

    def jacobian_end_effector_position(self, x):
        return jnp.array(
            [
                [1.0, 0.0, x[3] * jnp.cos(x[2]), jnp.sin(x[2])],
                [0.0, 1.0, x[3] * jnp.sin(x[2]), -jnp.cos(x[2])],
            ]
        )

    def _M_inv_diag(self):
        s = self.scn
        return jnp.array(
            [
                1.0 / (s.mass_body + s.mass_leg),
                1.0 / (s.mass_body + s.mass_leg),
                1.0 / (s.inertia_body + s.inertia_leg),
                1.0 / s.mass_leg,
            ]
        )

    def b(self, x, u):
        """Manipulator-equation drift (hopper.py:217-231)."""
        s = self.scn
        q_dot = x[4:]
        u_robot, contact_forces = u[:2], u[2:]
        C = jnp.array([0.0, (s.mass_body + s.mass_leg) * s.gravity, 0.0, 0.0])
        B = jnp.array(
            [[0.0, 0.0, 1.0, 0.0], [-jnp.sin(x[2]), jnp.cos(x[2]), 0.0, 1.0]]
        ).T
        J = self.jacobian_end_effector_position(x)
        q_ddot = self._M_inv_diag() * (-C + B @ u_robot + J.T @ contact_forces)
        return jnp.concatenate([q_dot, q_ddot])

    def friction_at_px(self, px, field_row):
        """mu(px) for one friction-field sample (hopper.py:75-81)."""
        i, th, ta = field_row
        return self.scn.mu_nom + jnp.sum(i * jnp.cos(th * px + ta))

    # -- constraint families (reference order) -----------------------------
    def dynamics_defects(self, xs, us):
        """RK4 defects x_{t+1} - RK4(x_t, u_t) (hopper.py:239-254)."""
        dt = self.dt

        def defect(x, u, xn):
            k1 = self.b(x, u)
            k2 = self.b(x + 0.5 * dt * k1, u)
            k3 = self.b(x + 0.5 * dt * k2, u)
            k4 = self.b(x + dt * k3, u)
            return xn - (x + (k1 + 2 * k2 + 2 * k3 + k4) * dt / 6.0)

        return jax.vmap(defect)(xs[:-1], us, xs[1:]).reshape(-1)

    def g_all(self, Z, field: FrictionField, method: str, alpha: float = 0.1):
        """Full constraint stack in reference order (hopper.py:486-514)."""
        s = self.scn
        tj, tl = s.time_jump, s.time_land
        xs, us, ys, slack, t_risk = self.split_z(Z)
        ee = jax.vmap(self.end_effector_position)(xs)  # (S+1, 2)

        gs_dyn = self.dynamics_defects(xs, us)
        gs_x0 = xs[0] - self._state_initial
        gs_xf = (xs[-1] - self._state_final)[4:6]
        # no-slip equality: J_row0 . q_dot = 0 on contact phases
        J_rows = jax.vmap(self.jacobian_end_effector_position)(xs)[:, 0, :]
        no_slip_all = jnp.sum(J_rows * xs[:, 4:], axis=1)  # (S+1,)
        gs_slip = jnp.concatenate([no_slip_all[:tj], no_slip_all[tl:]])
        gs_contact = jnp.concatenate([ee[:tj, 1], ee[tl:, 1]])
        gs_over = -ee[tj:tl, 1]

        # slip-risk family (hopper.py:300-367)
        px_c = jnp.concatenate([ee[:tj, 0], ee[tl:-1, 0]])  # (C,)
        forces = jnp.concatenate([us[:tj, 2:], us[tl:, 2:]])  # (C, 2)

        def slip_one_sample(i, th, ta):
            mu = s.mu_nom + jnp.sum(
                i[None, :] * jnp.cos(th[None, :] * px_c[:, None] + ta[None, :]),
                axis=1,
            )  # (C,)
            return forces[:, 0] - mu * forces[:, 1]

        cons = jax.vmap(slip_one_sample)(
            field.intensities, field.thetas, field.taus
        )  # (M, C)
        M = field.intensities.shape[0]
        if method == "baseline":
            gs_risk = (cons - slack).reshape(-1)
        else:
            head = ((M * alpha) * t_risk + jnp.sum(ys))[None]
            gs_risk = jnp.concatenate(
                [
                    head,
                    -ys,
                    (cons - t_risk - ys[:, None] - slack).reshape(-1),
                    jnp.zeros(1, Z.dtype),  # reference trailing zero row
                ]
            )

        gs_control = us.reshape(-1)
        gs_slack = slack[None]
        gs_len = jnp.concatenate([xs[1:, 3], xs[1:, 7], xs[1:, 6]])

        return jnp.concatenate(
            [
                gs_dyn,
                gs_x0,
                gs_xf,
                gs_slip,
                gs_contact,
                gs_over,
                gs_risk,
                gs_control,
                gs_slack,
                gs_len,
            ]
        )

    def bounds(self, method: str, M: int, dtype=jnp.float64):
        """(g_L, g_U, n_eq) following gL_gU (hopper.py:515-562) and
        (x_L, x_U) following hopper.py:599-620."""
        s = self.scn
        n_dyn = s.S * s.n_x
        n_eqp = len(self.eq_phase_idx)
        n_eq = n_dyn + s.n_x + 2 + n_eqp + n_eqp
        n_over = len(self.flight_idx)
        n_risk = (
            M * self.num_contacts if method == "baseline"
            else 1 + M + M * self.num_contacts + 1
        )
        big = 1e15

        gL = [jnp.zeros(n_eq)]
        gU = [jnp.zeros(n_eq)]
        # one-sided: flight clearance + slip risk: g <= 0
        gL.append(jnp.full(n_over + n_risk, -big))
        gU.append(jnp.zeros(n_over + n_risk))
        # control rows (hopper.py:393-428): motors +/-u_max; contact forces in
        # [0, max_contact_force] during stance, pinned to 0 in flight
        cl = np.zeros((s.S, s.n_u))
        cu = np.zeros((s.S, s.n_u))
        cl[:, :2], cu[:, :2] = -s.u_max, s.u_max
        for t in range(s.S):
            if s.time_jump <= t < s.time_land:
                cl[t, 2:], cu[t, 2:] = 0.0, 0.0
            else:
                cl[t, 2:], cu[t, 2:] = 0.0, s.max_contact_force
        gL.append(jnp.asarray(cl.reshape(-1)))
        gU.append(jnp.asarray(cu.reshape(-1)))
        # slack in [0, 1e6]
        gL.append(jnp.zeros(1))
        gU.append(jnp.full(1, 1e6))
        # length / leg speed / omega (hopper.py:369-390)
        gL.append(
            jnp.concatenate(
                [jnp.full(s.S, 0.25), jnp.full(s.S, -4.0), jnp.full(s.S, -2.5)]
            )
        )
        gU.append(
            jnp.concatenate(
                [jnp.full(s.S, 1.0), jnp.full(s.S, 4.0), jnp.full(s.S, 2.5)]
            )
        )
        g_L = jnp.concatenate(gL).astype(dtype)
        g_U = jnp.concatenate(gU).astype(dtype)

        nv = (s.S + 1) * s.n_x + s.S * s.n_u + M + 2
        xL = np.full(nv, -1000.0)
        xU = np.full(nv, 1000.0)
        for t in range(s.S + 1):
            i = t * s.n_x
            xL[i], xU[i] = -3.0, 3.0  # px
            xL[i + 1], xU[i + 1] = 0.5, 10.0  # pz
            xL[i + 2], xU[i + 2] = -np.pi / 2, np.pi / 2  # phi
            xL[i + 3], xU[i + 3] = 0.1, 3.0  # r
            xL[i + 4 : i + 8] = -500.0
            xU[i + 4 : i + 8] = 500.0
        return g_L, g_U, n_eq, jnp.asarray(xL, dtype), jnp.asarray(xU, dtype)

    # -- objective (hopper.py:441-453) -------------------------------------
    def f(self, Z):
        xs, us, ys, slack, t_risk = self.split_z(Z)
        obj = jnp.sum(us[:, 0] ** 2) + jnp.sum(us[:, 1] ** 2)
        obj = obj - 10000.0 * xs[-1, 0]
        obj = obj + 1e7 * slack
        return obj

    # -- sampling (hopper.py:69-74, MC at 974-979) -------------------------
    def sample_friction(self, key, M: int, method: str = "saa") -> FrictionField:
        s = self.scn
        k1, k2, k3 = jax.random.split(key, 3)
        F = s.num_mu_features
        intensities = (
            s.mu_intensity_scale
            * jnp.sqrt(2.0 / F)
            * jax.random.uniform(k1, (M, F))
        )
        thetas = jax.random.uniform(k2, (M, F), maxval=jnp.pi)
        taus = jax.random.uniform(k3, (M, F), maxval=2 * jnp.pi)
        if method == "baseline":
            intensities = 0 * intensities
            thetas = 0 * thetas
            taus = 0 * taus
        return FrictionField(intensities, thetas, taus)

    # -- initial guess (hopper.py:136-164) ---------------------------------
    def initial_guess(self, M: int, dtype=jnp.float64):
        s = self.scn
        Zp = np.zeros((s.S + 1) * s.n_x + s.S * s.n_u + M + 2)
        x0 = np.asarray(s.state_initial)
        xf = np.asarray(s.state_final)
        for t in range(s.time_land):
            Zp[t * s.n_x : (t + 1) * s.n_x] = x0
        for t in range(s.time_land, s.S + 1):
            Zp[t * s.n_x : (t + 1) * s.n_x] = xf
        nominal_force = (s.mass_body + s.mass_leg) * s.gravity
        off = (s.S + 1) * s.n_x
        for t in range(0, s.time_jump):
            Zp[off + t * s.n_u + 1] = nominal_force
            Zp[off + t * s.n_u + 3] = nominal_force
        for t in range(s.time_land, s.S):
            Zp[off + t * s.n_u + 1] = nominal_force
            Zp[off + t * s.n_u + 3] = nominal_force
        return jnp.asarray(Zp, dtype)

    # -- solver plumbing ---------------------------------------------------
    def make_nlp(self, field: FrictionField, method: str, alpha: float):
        """Return (f, g, bounds...) closures for the NLP solver."""
        M = field.intensities.shape[0]

        def g_fn(Z):
            return self.g_all(Z, field, method, alpha)

        g_L, g_U, n_eq, xL, xU = self.bounds(method, M)
        return self.f, g_fn, g_L, g_U, n_eq, xL, xU

    def make_nlp_params(self, field: FrictionField, method: str, alpha: float):
        """Arg-rooted variant of `make_nlp` for jitted/vmapped barrier solves.

        Returns (f(Z, p), g(Z, p), params, g_L, g_U, n_eq, xL, xU): the
        friction-field arrays and the model's array constants travel in the
        `params` pytree instead of being closure-baked into the jaxpr
        (ops/nlp_ipm.solve_nlp notes). `params` is also the vmap
        axis for batched NLP solves over independent friction-field draws."""
        M = field.intensities.shape[0]
        params = {"field": field, "mc": self.consts()}

        def f_fn(Z, p):
            return self.f(Z)

        def g_fn(Z, p):
            m = self.bind(p["mc"])
            return m.g_all(Z, p["field"], method, alpha)

        g_L, g_U, n_eq, xL, xU = self.bounds(method, M)
        return f_fn, g_fn, params, g_L, g_U, n_eq, xL, xU
