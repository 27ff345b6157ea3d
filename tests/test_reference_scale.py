"""Reference-configuration runs in CI (slow-marked): the exact sizes the
reference uses — car M=50 / 15 SCP iterations (car/driving_params.py:6-12,
driving.py:58-60), drone M=50 / 60 SCP iterations (drone/drone_params.py:7,
drone_risk.py:56) — asserting the SAA guarantees on the training set
(CVaR_alpha of the max constraint <= 0 up to solver tolerance, safety
fraction >= 1-alpha) plus out-of-sample MC behavior, on CPU x64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riskaversetrajopt_tpu.core.config import CarScenario, DroneScenario
from riskaversetrajopt_tpu.models.car import CarModel
from riskaversetrajopt_tpu.models.drone import DroneModel
from riskaversetrajopt_tpu.ops.cvar import avar
from riskaversetrajopt_tpu.ops.rollout import rollout
from riskaversetrajopt_tpu.scp.driver import SAATrajOpt


def _training_stats(opt, us, omegas):
    model = opt.model

    def one(om):
        xs = rollout(model, us, om)
        return jnp.max(model.ineq_constraints(xs, om))

    return jax.vmap(one)(omegas)


@pytest.mark.slow
def test_drone_reference_config():
    alpha = 0.1
    model = DroneModel(DroneScenario())
    opt = SAATrajOpt(model, method="saa",
                     scp_cfg=model.default_scp_config())  # 60 iters
    om = opt.sample(jax.random.PRNGKey(0), M=50)
    res = opt.solve(om, alpha=alpha)
    assert bool(jnp.all(res.qp_solved[2:])), "post-gating QP not converged"
    assert float(res.l2_errors[-1]) < 1e-3

    tol = model.scn.osqp_tol
    max_g = _training_stats(opt, res.us, om)
    # SAA training guarantees: CVaR_alpha(max g) <= 0 (+tol) and the safe
    # fraction >= 1 - alpha (drone_risk.py:55-56 semantics)
    assert float(avar(max_g, alpha)) <= tol + 1e-6
    assert float(jnp.mean(max_g <= tol + 1e-6)) >= 1.0 - alpha

    # out-of-sample MC (fresh 2000 samples): close to the 1-alpha target
    mc_om = opt.sample(jax.random.PRNGKey(7), M=2000)
    mc = opt.monte_carlo(res.us, mc_om, alpha)
    assert float(mc["safe_frac"]) >= 1.0 - alpha - 0.05


@pytest.mark.slow
def test_car_reference_config():
    alpha = 0.1
    model = CarModel(CarScenario())
    opt = SAATrajOpt(model, method="saa",
                     scp_cfg=model.default_scp_config())  # 15 iters
    om = opt.sample(jax.random.PRNGKey(1), M=50)
    res = opt.solve(om, alpha=alpha)
    assert bool(jnp.all(res.qp_solved[1:])), "post-gating QP not converged"
    assert float(res.l2_errors[-1]) < 1e-2  # reference car runs 15 iters only

    tol = model.scn.osqp_tol
    max_g = _training_stats(opt, res.us, om)
    assert float(avar(max_g, alpha)) <= tol + 1e-6
    assert float(jnp.mean(max_g <= tol + 1e-6)) >= 1.0 - alpha

    mc_om = opt.sample(jax.random.PRNGKey(8), M=2000)
    mc = opt.monte_carlo(res.us, mc_om, alpha)
    assert float(mc["safe_frac"]) >= 1.0 - alpha - 0.05
