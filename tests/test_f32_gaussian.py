"""True-f32 end-to-end Gaussian-baseline workloads (the f32 speed regime).

Both Gaussian planners default to f64 and are reference-validated on CPU
x64; these tests certify the f32 paths end-to-end:

- car: the SCP QPs carry the reference's OSQP_TOL=1e-8 stress tolerance
  (car/driving_gaussian.py:27) — far below the f32 floor — solved by the
  warm-started dense ADMM + compensated iterative refinement
  (ops/qp_refine.solve_dense_qp_ir). Quality gate: the f32 trajectory
  matches this process's x64 IPM solve within 1e-3 relative L2
  (measured 7e-5).
- drone: the risk-allocation NLP (ops/nlp_ipm.py) in f32 with symmetric
  KKT equilibration (kkt_ruiz_iters=3, the hopper hardening).

True f32 needs x64 disabled process-wide (planner constants bake the
default dtype), so the f32 legs run in subprocesses while the x64
references run inline under the suite's conftest.
"""

import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

_REPO = str(pathlib.Path(__file__).parent.parent)

_CAR_SCRIPT = r"""
import json
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp
import numpy as np
from riskaversetrajopt_tpu.core.config import CarScenario
from riskaversetrajopt_tpu.models.car_gaussian import GaussianCarPlanner

assert jnp.zeros(1).dtype == jnp.float32
p = GaussianCarPlanner(CarScenario(), alpha=0.05, num_scp_iters=20,
                       dtype=jnp.float32)
res = jax.jit(p.solve)()
print("RESULT " + json.dumps({
    "us": np.asarray(res.us).tolist(),
    "solved": [bool(v) for v in np.asarray(res.qp_solved).tolist()],
    "l2_final": float(res.l2_errors[-1]),
    "sum_alphas": float(np.sum(np.asarray(res.alphas_risk))),
}))
"""

_DRONE_SCRIPT = r"""
import json
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp
import numpy as np
from riskaversetrajopt_tpu.core.config import DroneScenario
from riskaversetrajopt_tpu.models.drone_gaussian import GaussianDronePlanner

assert jnp.zeros(1).dtype == jnp.float32
us_init = jnp.asarray(np.load("US_INIT"), jnp.float32)
p = GaussianDronePlanner(DroneScenario(), alpha=0.1, dtype=jnp.float32)
res = p.solve(us_init)
print("RESULT " + json.dumps({
    "us": np.asarray(res.us).tolist(),
    "solved": bool(res.nlp.solved),
    "prim": float(res.nlp.prim_res),
    "dual": float(res.nlp.dual_res),
    "iters": int(res.nlp.iters),
}))
"""


def _run_f32(script):
    proc = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True, text=True, timeout=1800,
        env={"PYTHONPATH": _REPO, "PATH": "/usr/bin:/bin:/usr/local/bin",
             "HOME": "/root"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, proc.stdout + proc.stderr
    return json.loads(line[0][len("RESULT "):])


@pytest.mark.slow
def test_f32_car_gaussian_matches_x64():
    from riskaversetrajopt_tpu.core.config import CarScenario
    from riskaversetrajopt_tpu.models.car_gaussian import GaussianCarPlanner

    r = _run_f32(_CAR_SCRIPT)
    assert all(r["solved"]), r["solved"]  # 1e-8 certified on every QP
    assert abs(r["sum_alphas"] - 0.05) < 1e-3

    p64 = GaussianCarPlanner(CarScenario(), alpha=0.05, num_scp_iters=20)
    res64 = jax.jit(p64.solve)()
    us64 = np.asarray(res64.us)
    us32 = np.asarray(r["us"])
    err = np.linalg.norm(us32 - us64) / np.linalg.norm(us64)
    assert err <= 1e-3, f"f32 vs x64 relative L2 = {err:.3e}"


@pytest.mark.slow
@pytest.mark.xfail(
    strict=False,
    reason="Open round-5 negative result: the f32 barrier NLP converges in "
    "primal (1e-6) and complementarity (1e-7) but the dual residual stalls "
    "at ~1-2 under every hardening combination probed (kkt_ruiz 3/5, "
    "kkt_ds_refine 2, damping, compensated merit — logs/probe_dg_f32.log), "
    "and the trajectory lands 0.27-0.36 from the x64 optimum. Suspected "
    "constraint-scaling issue (large multipliers on quantile-padded rows); "
    "the f32-supported Gaussian workload is the car planner "
    "(test_f32_car_gaussian_matches_x64, 7e-5).",
)
def test_f32_drone_gaussian_matches_x64(tmp_path):
    from riskaversetrajopt_tpu.core.config import DroneScenario
    from riskaversetrajopt_tpu.models.drone import DroneModel
    from riskaversetrajopt_tpu.models.drone_gaussian import (
        GaussianDronePlanner,
    )
    from riskaversetrajopt_tpu.scp.driver import SAATrajOpt

    # SAA warm start (the reference's cross-script contract,
    # drone_gaussian.py:104-116) — quick M=8 instance
    model = DroneModel(DroneScenario(M=8))
    opt = SAATrajOpt(model, method="saa")
    om = opt.sample(jax.random.PRNGKey(0), M=8)
    us_init = np.asarray(opt.solve(om, alpha=0.1).us)
    init_path = str(tmp_path / "us_init.npy")
    np.save(init_path, us_init)

    r = _run_f32(_DRONE_SCRIPT.replace("US_INIT", init_path))
    assert r["solved"], r

    p64 = GaussianDronePlanner(DroneScenario(), alpha=0.1)
    res64 = p64.solve(jnp.asarray(us_init))
    us64 = np.asarray(res64.us)
    us32 = np.asarray(r["us"])
    err = np.linalg.norm(us32 - us64) / np.linalg.norm(us64)
    assert err <= 1e-3, f"f32 vs x64 relative L2 = {err:.3e}"
