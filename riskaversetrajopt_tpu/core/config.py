"""Typed configuration for scenarios, solvers, SCP and device meshes.

The reference spreads configuration over per-workload parameter modules
(``car/driving_params.py``, ``drone/drone_params.py``), inline constants
(``hopper/hopper.py:43-89``) and hand-edited script booleans. Here every knob
is a typed dataclass; the exact reference values are provided as constructor
classmethods so workloads are reproducible bit-for-bit at the math level.

Shape/dimension fields are plain Python ints (static under jit); physical
parameters that enter traced computations are floats or jnp arrays captured by
closure.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class SCPConfig:
    """Sequential-convex-programming driver knobs.

    Mirrors the reference's script-level constants: ``num_scp_iters_max``
    (car/driving.py:60 -> 15, drone/drone_risk.py:56 -> 60),
    iteration-gated constraint activation (car/driving.py:411-415,
    drone/drone_risk.py:413-417), and the warm-up compile pass.
    """

    num_iters: int = 15
    # Number of initial iterations during which risk/obstacle constraints are
    # relaxed. Car uses 1 (rows zeroed, driving.py:411-415); drone uses 2
    # (rows scaled by 1e-7 and bounds clamped to +/-0.1, drone_risk.py:413-417).
    gate_iters: int = 2
    # Row-scale applied to gated constraint rows (drone: 1e-7; car: 0.0).
    gate_row_scale: float = 1e-7
    # Bounds applied to gated rows. Drone: (-0.1, 0.1); car: (-inf, 0.0) — the
    # reference's `ls[n_x:] *= 0` on -inf lower bounds produces NaNs that
    # OSQP's c_max clamping turns back into -infinity (see
    # ops/saa_qp.py module docstring).
    gate_bound_l: float = -0.1
    gate_bound_u: float = 0.1


@dataclass(frozen=True)
class SolverConfig:
    """ADMM QP solver knobs with OSQP-equivalent semantics.

    eps_abs/eps_rel mirror ``OSQP_TOL`` (driving_params.py:4 -> 3e-4,
    drone_params.py:4 -> 1e-3, car/driving_gaussian.py:27 -> 1e-8).
    """

    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    max_iter: int = 4000
    check_every: int = 25
    rho: float = 0.1
    rho_eq_scale: float = 1e3  # OSQP scales rho on equality rows by 1e3
    # Start each SCP subproblem's ADMM from the PREVIOUS QP's adapted rho
    # (OSQP keeps rho in its workspace across the reference's
    # setup-once-then-update loop, drone_risk.py:425-452); rho is re-adapted
    # normally from there. False = always start from cfg.rho. Default OFF:
    # the golden-trajectory harness (tools/reference_oracle.py) restarts rho
    # per QP, and enabling this shifts the SCP solution branch enough to
    # break the 1e-3 golden-tracking contract
    # (tests/test_reference_parity.py: 2.2e-3 vs 1e-3 at car M=50). The
    # bench's speed mode opts in (bench.make): measured 2-3x fewer ADMM
    # iterations on the post-transition tail QPs at M=1000.
    rho_warm_start: bool = False
    # Adaptive-rho epoch cadence. 0 (default) = event-driven: the inner
    # fixed-rho loop exits whenever a termination check requests a
    # refactorization (ops/admm.py two-level while). >0 = FIXED-CADENCE:
    # rho updates/refactorizations happen every `rho_epoch_every`
    # iterations regardless. Use the fixed cadence for VMAPPED (batched)
    # solves: under vmap the event-driven handshake lets one element's
    # refactor request freeze it until every element exits the inner loop,
    # desynchronizing rho adaptation across the batch — measured at B=4,
    # M=1000: the same instance takes 12075 iterations batched vs 3200
    # serial (PARITY.md round 3).
    rho_epoch_every: int = 0
    # Refactorize when the adapted rho moves by more than this factor from
    # the current one (OSQP default 5). Smaller = more eager rho tracking;
    # a refactorization is one (n+2)-dim dense Cholesky of the structured
    # Schur block, so eagerness is cheap here relative to OSQP's sparse
    # LDL^T.
    rho_update_factor: float = 5.0
    sigma: float = 1e-6
    alpha_relax: float = 1.6
    adaptive_rho: bool = True
    adaptive_rho_interval: int = 50
    polish: bool = True
    polish_refine_iters: int = 3
    # Iterative-refinement steps applied to KKT solves (helps f32).
    kkt_refine_iters: int = 1
    # Residual operator for in-iteration KKT refinement: "true" (exact
    # residual via 2 extra G-sweeps per pass; also corrects the
    # factor-formation error) or "factored" (residual against the stored
    # Schur blocks; ~0 extra memory traffic, corrects the triangular-solve
    # roundoff only). See ops/saa_qp.SAAQPOps.
    kkt_refine_mode: str = "true"
    # Refine the KKT solve only every P-th ADMM iteration (1 = every
    # iteration). Each refinement pass costs 2 extra G-sweeps, the
    # memory-heavy core of the structured iteration. Measured (M=1000 f32,
    # eps 1e-4 + polish; PARITY.md round 3): period=4 is a false economy —
    # alternating between the refined and unrefined fixed-point maps makes
    # the iterate wander (17075 total ADMM iterations vs 5725 at period=1,
    # SCP l2_final 9.3e-2 vs 5.7e-3). Kept for experimentation; leave at
    # 1 for production.
    kkt_refine_period: int = 1
    # Apply the Schur-complement solve through a PRECOMPUTED explicit
    # inverse (one (n+2)x(n+2) matvec per solve) instead of two sequential
    # triangular solves. solve_triangular at n+2 ~ 62 is latency-bound, and
    # with kkt_refine_iters=1 the iteration runs 4 of them. The inverse is
    # formed once per rho epoch; its application error is the same
    # cond(S)*eps order as the triangular solve's and the in-iteration
    # refinement contracts both identically. Default off (OSQP-parity
    # semantics); the bench's speed mode (bench.make) opts in.
    kkt_chol_inverse: bool = False
    # Matmul precision of the per-iteration G-sweeps in f32 (matvec_A /
    # rmatvec_A in ops/saa_qp.py — the einsums over the (M, K, n) Jacobian
    # stack that dominate ADMM iteration cost at M=1000). On the H100:
    # "highest" = full f32; "high" = TF32 (10-bit mantissa, ~1e-3 relative);
    # "default" = XLA's choice, TF32 for f32. Lower precision is known to
    # slow ADMM convergence; do not use it for solves. f64 sweeps are f64
    # whatever this says. Factorization, define-phase and golden
    # comparisons stay HIGHEST regardless.
    sweep_precision: str = "highest"
    scaled_termination: bool = False
    # Inexact-SCP tolerance schedule: SCP subproblems with
    # scp_iter < eps_sched_iters terminate at eps_sched_factor * eps
    # (both thresholds scaled; traced, so one compiled program serves the
    # whole schedule). Rationale: early QPs — including the expensive
    # post-gating transition QP, which costs 3400-7700 of a solve's ~9600
    # ADMM iterations at M=1000 — only seed the next linearization, and the
    # reference itself solves EVERY QP at the loose OSQP_TOL
    # (drone_params.py:4). 0 = off (every QP at the full tolerance).
    eps_sched_iters: int = 0
    eps_sched_factor: float = 1.0
    # Termination-check interval backoff: when a check finds the residuals
    # >100x away from tolerance, the next check is scheduled at double the
    # interval (up to check_backoff_max * check_every), resetting to
    # check_every once within range. Each check costs ~2 full-Jacobian
    # sweeps at M=1000, so long transition solves spend less on checking.
    # 1 = off (check every check_every iterations, OSQP default behavior).
    check_backoff_max: int = 1
    # Safeguarded type-II Anderson acceleration depth for the ADMM
    # fixed-point iteration (0 = off). History restarts at every
    # termination check / rho epoch. Opt-in: attacks iteration count on
    # the long post-gating transition QPs; per-iteration overhead is the
    # history roll + a depth^2 Gram solve.
    anderson_depth: int = 0
    # 'admm-ds' backend only: compensated-true-residual refinement rounds
    # applied to each KKT solve on top of the f32 factor (each round costs
    # 2 ds Jacobian sweeps and contracts the solve error by ~cond(S)*eps).
    ds_kkt_passes: int = 1


@dataclass(frozen=True)
class PDIPConfig:
    """Primal-dual interior-point NLP solver knobs (IPOPT-equivalent).

    tol mirrors ipopt options (hopper/hopper.py:642-645 -> tol 1e-3,
    drone/drone_gaussian.py:500-502 -> tol 1e-8).
    """

    tol: float = 1e-6
    max_iter: int = 300
    mu_init: float = 1e-1
    kappa_mu: float = 0.2
    theta_mu: float = 1.5
    tau_min: float = 0.99
    reg_init: float = 1e-8
    reg_max: float = 1e8
    # Slack/bound relaxation used when restoring feasibility.
    bound_push: float = 1e-2
    bound_frac: float = 1e-2


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: samples sharded over `sample_axis` devices, and an
    optional independent-problem batch axis (the (alpha x repeat) sweep axis).

    The reference has no distributed backend (every script pins
    ``jax_platform_name='cpu'``, car/driving.py:18); SAA sample-parallelism is
    the framework's data parallelism (SURVEY.md section 2.3).
    """

    sample_devices: int = 1
    batch_devices: int = 1
    sample_axis: str = "samples"
    batch_axis: str = "batch"


# ---------------------------------------------------------------------------
# Scenario configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DroneScenario:
    """Drone point-mass with quadratic drag, feedback-corrected control, mass
    uncertainty and uncertain ellipsoidal obstacles.

    Values mirror drone/drone_params.py:1-45 exactly.
    """

    n_x: int = 6
    n_u: int = 3
    S: int = 20
    M: int = 50
    T: float = 50.0
    u_max: float = 10.0
    mass_nom: float = 32.0
    mass_delta: float = 3.0
    beta: float = 1e-2
    drag_coefficient: float = 0.2
    n_obs: int = 3
    obs_radii_deltas: float = 0.025
    osqp_tol: float = 1e-3

    @property
    def dt(self) -> float:
        return self.T / self.S

    # Arrays (non-hashable, accessed as properties so the dataclass itself
    # stays hashable/static).
    @property
    def R(self) -> jnp.ndarray:
        return jnp.eye(self.n_u)

    @property
    def feedback_gain(self) -> jnp.ndarray:
        K = jnp.zeros((self.n_u, self.n_x))
        K = K.at[:, :3].set(0.05 * jnp.eye(self.n_u))
        K = K.at[:, 3:].set(0.25 * jnp.eye(self.n_u))
        return -K

    @property
    def obs_positions(self) -> jnp.ndarray:
        return jnp.array([[-1.4, -0.1, 0.0], [-0.7, 0.3, 0.0], [-0.3, 0.25, 0.0]])

    @property
    def obs_radii(self) -> jnp.ndarray:
        return jnp.array([0.3, 0.2, 0.2])

    @property
    def x_init(self) -> jnp.ndarray:
        return jnp.array([-1.9, 0.05, 0.2, 0.0, 0.0, 0.0])

    @property
    def x_final(self) -> jnp.ndarray:
        return jnp.zeros(self.n_x)


@dataclass(frozen=True)
class CarScenario:
    """Planar ego car + interactive pedestrian (social-force model).

    Values mirror car/driving_params.py:1-42 exactly.
    """

    n_x: int = 8
    n_u: int = 2
    S: int = 20
    M: int = 50
    T: float = 10.0
    u_max: float = 100.0
    beta: float = 3e-2  # diffusion magnitude, car/driving.py:94
    omega_speed_nom: float = 0.1
    omega_speed_del: float = 0.075
    omega_repulsive_nom: float = 0.05
    omega_repulsive_del: float = 0.045
    ego_width: float = 2.695
    ego_height: float = 1.663
    ped_radius: float = 0.5
    speed_ped_des: float = 1.3
    osqp_tol: float = 3e-4

    @property
    def dt(self) -> float:
        return self.T / self.S

    @property
    def R(self) -> jnp.ndarray:
        return jnp.diag(jnp.array([1.0, 1.0 / 3.0]))

    @property
    def min_separation_distance(self) -> float:
        return float(self.ped_radius + np.sqrt(self.ego_width**2 + self.ego_height**2))

    @property
    def position_ego_init(self) -> jnp.ndarray:
        return jnp.array([-20.0, 0.0])

    @property
    def position_ped_init(self) -> jnp.ndarray:
        return jnp.array([0.0, -6.0])

    @property
    def velocity_ego_init(self) -> jnp.ndarray:
        return jnp.array([4.0, 0.0])

    @property
    def velocity_ped_init(self) -> jnp.ndarray:
        return jnp.array([0.0, self.speed_ped_des])

    @property
    def position_ego_goal(self) -> jnp.ndarray:
        return jnp.array([20.0, 0.1])

    @property
    def velocity_ego_goal(self) -> jnp.ndarray:
        return jnp.array([4.1, 0.0])

    @property
    def state_init(self) -> jnp.ndarray:
        return jnp.concatenate(
            (
                self.position_ego_init,
                self.velocity_ego_init,
                self.position_ped_init,
                self.velocity_ped_init,
            ),
            axis=-1,
        )

    @property
    def variance_ped_initial_state(self) -> jnp.ndarray:
        return jnp.diag(jnp.array([1e-1, 1e-1, 1e-4, 1e-4]) ** 2)


@dataclass(frozen=True)
class HopperScenario:
    """2-D single-leg hopper with contact-implicit direct transcription.

    Values mirror hopper/hopper.py:43-89 exactly (dynamics credited there to
    dojo-sim/ContactImplicitMPC.jl).
    """

    n_x: int = 8
    n_u: int = 4
    S: int = 30
    M: int = 30
    T: float = 2.0
    time_jump: int = 10
    time_land: int = 20
    u_max: float = 1000.0
    mass_body: float = 3.0
    mass_leg: float = 0.3
    inertia_body: float = 0.75
    inertia_leg: float = 0.075
    gravity: float = 9.81
    max_contact_force: float = 1000.0
    mu_nom: float = 0.10
    num_mu_features: int = 30
    mu_intensity_scale: float = 0.025

    @property
    def dt(self) -> float:
        return self.T / self.S

    @property
    def num_vars(self) -> int:
        return (self.S + 1) * self.n_x + self.S * self.n_u + self.M + 2

    @property
    def state_initial(self) -> jnp.ndarray:
        return jnp.array([1e-6, 1.0, -1e-6, 1.0, 0.0, 0.0, 0.0, 0.0]) + 2e-7

    @property
    def state_final(self) -> jnp.ndarray:
        return jnp.array([0.15, 1.0, -1e-6, 1.0, 0.0, 0.0, 0.0, 0.0]) + 2e-7


def replace(cfg, **kwargs):
    """Convenience dataclasses.replace wrapper."""
    return dataclasses.replace(cfg, **kwargs)
