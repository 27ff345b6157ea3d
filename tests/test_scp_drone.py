"""End-to-end SCP tests on the drone workload: convergence of the control
iterates, terminal-constraint satisfaction, obstacle avoidance on the training
samples, and Monte-Carlo out-of-sample validation (the reference's de-facto
integration test, SURVEY.md section 4)."""

import jax
import jax.numpy as jnp
import numpy as np

from riskaversetrajopt_tpu.core.config import DroneScenario, SCPConfig
from riskaversetrajopt_tpu.models.drone import DroneModel
from riskaversetrajopt_tpu.scp.driver import SAATrajOpt


def test_drone_saa_scp_end_to_end():
    model = DroneModel(DroneScenario())
    opt = SAATrajOpt(
        model,
        method="saa",
        scp_cfg=SCPConfig(
            num_iters=25, gate_iters=2, gate_row_scale=1e-7,
            gate_bound_l=-0.1, gate_bound_u=0.1,
        ),
    )
    M = 8
    omegas = opt.sample(jax.random.PRNGKey(0), M=M)
    res = opt.solve(omegas, alpha=0.2)

    l2 = np.asarray(res.l2_errors)
    # SCP iterates converge (reference plots these on a log scale,
    # car/driving.py:758-785)
    assert l2[-1] < 5e-3, f"L2 errors: {l2}"
    # all post-gating QP solves succeeded
    assert bool(jnp.all(res.qp_solved[3:])), np.asarray(res.qp_iters)

    # terminal constraint in sample average: mean final state ~ x_final
    mean_final = np.asarray(jnp.mean(res.xs[:, -1, :], axis=0))
    np.testing.assert_allclose(
        mean_final, np.asarray(model.scn.x_final), atol=5e-3
    )

    # obstacle constraints hold on (most of) the training samples: with
    # alpha=0.2 and the CVaR reformulation, the average of the worst
    # (1-alpha) tail must be <= 0; check the empirical AVaR directly
    g_all = jax.vmap(lambda om, xs: model.ineq_constraints(xs, om))(
        omegas, res.xs
    )  # (M, K)
    worst_per_sample = np.asarray(jnp.max(g_all, axis=1))
    from riskaversetrajopt_tpu.ops.cvar import avar

    avar_val = float(avar(jnp.asarray(worst_per_sample), 0.2))
    assert avar_val <= 1e-2, f"AVaR of max constraint: {avar_val}"

    # controls respect bounds
    assert float(jnp.max(jnp.abs(res.us))) <= model.scn.u_max + 1e-6


def test_drone_monte_carlo_validation():
    model = DroneModel(DroneScenario())
    opt = SAATrajOpt(
        model,
        method="saa",
        scp_cfg=SCPConfig(
            num_iters=25, gate_iters=2, gate_row_scale=1e-7,
            gate_bound_l=-0.1, gate_bound_u=0.1,
        ),
    )
    omegas = opt.sample(jax.random.PRNGKey(1), M=16)
    alpha = 0.2
    res = opt.solve(omegas, alpha=alpha)

    mc_omegas = opt.sample(jax.random.PRNGKey(123), M=500)
    mc = opt.monte_carlo(res.us, mc_omegas, alpha)
    # out-of-sample safety should be near 1 - alpha (SAA guarantee is
    # asymptotic in M; small M gives slack, so use a loose bound)
    assert float(mc["safe_frac"]) > 0.5
    assert np.isfinite(float(mc["avar"]))
    assert float(mc["cost"]) > 0.0


def test_drone_baseline_scp():
    model = DroneModel(DroneScenario())
    opt = SAATrajOpt(
        model,
        method="baseline",
        scp_cfg=SCPConfig(
            num_iters=25, gate_iters=2, gate_row_scale=1e-7,
            gate_bound_l=-0.1, gate_bound_u=0.1,
        ),
        baseline_pad=1e-3,
    )
    M = 4
    omegas = opt.sample(jax.random.PRNGKey(0), M=M, method="baseline")
    res = opt.solve(omegas, alpha=0.1)
    l2 = np.asarray(res.l2_errors)
    assert l2[-1] < 5e-3, f"L2 errors: {l2}"
    # baseline avoids obstacles deterministically (with the 1e-3 padding)
    g_all = jax.vmap(lambda om, xs: model.ineq_constraints(xs, om))(
        omegas, res.xs
    )
    assert float(jnp.max(g_all)) <= 1e-2


def test_warm_rho_gate_transition_reset():
    """_warm_rho threads the previous QP's adapted rho across SCP
    iterations but restarts from cfg.rho at the gating transition
    (scp_iter == gate_iters), and returns None when disabled."""
    from riskaversetrajopt_tpu.core.config import SolverConfig

    model = DroneModel(DroneScenario())
    opt = SAATrajOpt(
        model, method="saa",
        scp_cfg=SCPConfig(num_iters=4, gate_iters=2, gate_row_scale=1e-7,
                          gate_bound_l=-0.1, gate_bound_u=0.1),
        admm_cfg=SolverConfig(rho=0.1, rho_warm_start=True),
        dtype=jnp.float32,
    )
    warm = (jnp.zeros(2), jnp.zeros(3), jnp.float32(7.0))
    # mid-loop: previous adapted rho carried through
    assert float(opt._warm_rho(warm, jnp.asarray(3))) == 7.0
    # gating transition: restart from cfg.rho
    assert float(opt._warm_rho(warm, jnp.asarray(2))) == np.float32(0.1)
    # disabled or legacy 2-tuple warm: None (solver uses cfg.rho)
    assert opt._warm_rho((warm[0], warm[1]), jnp.asarray(3)) is None
    opt.admm_cfg = SolverConfig(rho=0.1, rho_warm_start=False)
    assert opt._warm_rho(warm, jnp.asarray(3)) is None


def test_rho_warm_start_solves_equivalently():
    """With rho warm-starting enabled the SCP solves to the same quality
    (it changes the solver's internal rho path, not the problem)."""
    from riskaversetrajopt_tpu.core.config import SolverConfig

    model = DroneModel(DroneScenario())
    M = 8
    sols = {}
    for rw in (False, True):
        opt = SAATrajOpt(
            model, method="saa",
            scp_cfg=SCPConfig(num_iters=10, gate_iters=2,
                              gate_row_scale=1e-7,
                              gate_bound_l=-0.1, gate_bound_u=0.1),
            admm_cfg=SolverConfig(eps_abs=1e-6, eps_rel=1e-6,
                                  max_iter=20000, polish=False,
                                  rho_warm_start=rw),
        )
        omegas = opt.sample(jax.random.PRNGKey(0), M=M)
        res = opt.solve(omegas, alpha=0.2)
        assert bool(np.all(np.asarray(res.qp_solved)))
        sols[rw] = np.asarray(res.us)
    np.testing.assert_allclose(sols[True], sols[False], rtol=5e-3, atol=5e-3)


def test_eps_schedule_solves_equivalently():
    """Inexact-SCP tolerance schedule (SolverConfig.eps_sched_iters): early
    QPs terminate at factor * eps, final-stretch QPs at the full tolerance
    — the converged trajectory must match the unscheduled solve (the early
    subproblems only seed re-linearizations) and every QP still certifies
    at its (scheduled) tolerance."""
    from riskaversetrajopt_tpu.core.config import SolverConfig

    model = DroneModel(DroneScenario())
    M = 8
    sols = {}
    for sched in (0, 4):
        opt = SAATrajOpt(
            model, method="saa",
            scp_cfg=SCPConfig(num_iters=12, gate_iters=2,
                              gate_row_scale=1e-7,
                              gate_bound_l=-0.1, gate_bound_u=0.1),
            admm_cfg=SolverConfig(eps_abs=1e-6, eps_rel=1e-6,
                                  max_iter=20000, polish=False,
                                  eps_sched_iters=sched,
                                  eps_sched_factor=100.0),
        )
        omegas = opt.sample(jax.random.PRNGKey(0), M=M)
        res = opt.solve(omegas, alpha=0.2)
        assert bool(np.all(np.asarray(res.qp_solved)))
        if sched:
            # the schedule must actually bite: early QPs certify earlier
            assert int(np.asarray(res.qp_iters)[2]) <= int(
                np.asarray(sols[0][1])[2]
            )
        sols[sched] = (np.asarray(res.us), np.asarray(res.qp_iters))
    np.testing.assert_allclose(sols[4][0], sols[0][0], rtol=5e-3, atol=5e-3)


def test_eps_schedule_rejected_on_non_admm_backends():
    """The inexact-SCP schedule threads a traced eps multiplier into the
    'admm' backend only; other backends would silently ignore it, so the
    driver must fail loudly at construction."""
    import pytest

    from riskaversetrajopt_tpu.core.config import SolverConfig

    model = DroneModel(DroneScenario())
    with pytest.raises(ValueError, match="eps_sched_iters"):
        SAATrajOpt(
            model, method="saa", qp_backend="admm-ir",
            admm_cfg=SolverConfig(eps_sched_iters=3, eps_sched_factor=10.0),
        )


def test_solve_many_matches_per_instance_solves():
    """solve_many (the jitted scan-over-instances scheduler, the on-device
    answer to the reference's serially-solved alpha x repeat sweeps,
    drone_risk.py:498-503) must be BIT-IDENTICAL to solving each instance
    independently — each instance runs at its own convergence schedule,
    unlike lockstep vmap."""
    opt = SAATrajOpt(
        DroneModel(DroneScenario()),
        method="saa",
        scp_cfg=SCPConfig(
            num_iters=5, gate_iters=2, gate_row_scale=1e-7,
            gate_bound_l=-0.1, gate_bound_u=0.1,
        ),
    )
    B, M = 3, 10
    oms = [opt.sample(jax.random.PRNGKey(i), M=M) for i in range(B)]
    alphas = [0.1, 0.2, 0.3]
    om_st = jax.tree.map(lambda *xs: jnp.stack(xs), *oms)
    res_many = opt.solve_many(om_st, alphas)
    assert res_many.us.shape == (B, opt.model.S, opt.model.n_u)
    assert res_many.qp_iters.shape == (B, 5)
    for i in range(B):
        r = opt.solve(oms[i], alphas[i])
        np.testing.assert_array_equal(
            np.asarray(r.us), np.asarray(res_many.us[i])
        )
        np.testing.assert_array_equal(
            np.asarray(r.qp_iters), np.asarray(res_many.qp_iters[i])
        )
        np.testing.assert_array_equal(
            np.asarray(r.qp_solved), np.asarray(res_many.qp_solved[i])
        )


def test_hybrid_prox_demoted_to_experimental():
    """'hybrid-prox' fails at the flagship size (M=1000/f32: rescue IPM
    lands off the warm face) — the public name must raise with guidance,
    while the underscore-prefixed experimental opt-in still solves."""
    import pytest

    scp_cfg = SCPConfig(
        num_iters=3, gate_iters=1, gate_row_scale=1e-7,
        gate_bound_l=-0.1, gate_bound_u=0.1,
    )
    opt = SAATrajOpt(
        DroneModel(DroneScenario()), method="saa", scp_cfg=scp_cfg,
        qp_backend="hybrid-prox",
    )
    om = opt.sample(jax.random.PRNGKey(0), M=6)
    with pytest.raises(ValueError, match="admm-ir"):
        opt.solve(om, 0.2)
    opt_exp = SAATrajOpt(
        DroneModel(DroneScenario()), method="saa", scp_cfg=scp_cfg,
        qp_backend="_hybrid-prox",
    )
    res = opt_exp.solve(om, 0.2)
    assert bool(jnp.all(res.qp_solved))
