"""True-f32 end-to-end SCP quality parity (the bench's f32 regime).

The bench solves in f32. The f32 SCP cannot bit-track the x64 trajectory —
the post-gating QPs have degenerate optimal faces whose selected optimum
moves macroscopically under 1e-6-level linearization noise (the reference
has the same property: its own trajectory at its own OSQP tolerance sits
0.51 relative-L2 from its tightened-solver trajectory at M=50). What IS
preserved, and what this test asserts, is STATISTICAL solution quality on
out-of-sample Monte Carlo (the reference's own validation criterion,
drone_risk.py:643-762):

  - every QP certified `solved` at its tolerance (no silent caps),
  - safe fraction >= 1 - alpha,
  - AVaR_alpha of the max constraint <= ~0,
  - control cost within a modest factor of the x64 golden trajectory's.

Runs in a SUBPROCESS because true f32 needs x64 disabled process-wide
(model constants bake the default dtype at construction), while the suite
conftest enables x64.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

_SCRIPT = r"""
import json
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp
import numpy as np
from riskaversetrajopt_tpu.core.config import DroneScenario, SCPConfig, SolverConfig
from riskaversetrajopt_tpu.models.drone import DroneModel
from riskaversetrajopt_tpu.scp.driver import SAATrajOpt

assert jnp.zeros(1).dtype == jnp.float32
M = 50
model = DroneModel(DroneScenario(M=M))
om = model.sample(jax.random.PRNGKey(0), M=M)
scp_cfg = SCPConfig(num_iters=15, gate_iters=2, gate_row_scale=1e-7,
                    gate_bound_l=-0.1, gate_bound_u=0.1)
from riskaversetrajopt_tpu.ops.qp_refine import IRConfig
# work_eps 1e-5 keeps the base/correction solves on the warm-started-ADMM
# branch whose M=50 quality matches the x64 golden (cost 0.51 vs 0.43,
# safe 0.95); polish off — vertex snapping flips between consecutive
# degenerate QPs at M=50 and destabilizes the SCP tail.
opt = SAATrajOpt(model, method="saa", scp_cfg=scp_cfg, qp_backend="admm-ir",
                 admm_cfg=SolverConfig(eps_abs=1e-6, eps_rel=1e-6,
                                       max_iter=20000, polish=False,
                                       kkt_refine_iters=1),
                 ir_cfg=IRConfig(work_eps=1e-5),
                 dtype=jnp.float32)
res = opt.solve(om, alpha=0.2)
mc_om = model.sample(jax.random.PRNGKey(99), M=3000)
mc = opt.monte_carlo(jnp.asarray(res.us), mc_om, 0.2)
gold = np.load("GOLD_PATH")
mc_gold = opt.monte_carlo(jnp.asarray(gold, jnp.float32), mc_om, 0.2)
print("RESULT " + json.dumps({
    "solved": [bool(v) for v in res.qp_solved.tolist()],
    "safe": float(mc["safe_frac"]),
    "avar": float(mc["avar"]),
    "cost": float(mc["cost"]),
    "gold_safe": float(mc_gold["safe_frac"]),
    "gold_cost": float(mc_gold["cost"]),
}))
"""


@pytest.mark.slow
def test_f32_admm_ir_scp_quality():
    gold = str(
        pathlib.Path(__file__).parent / "fixtures" /
        "gold_drone_m50_a0.2_seed0_iters15.npy"
    )
    repo = str(pathlib.Path(__file__).parent.parent)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.replace("GOLD_PATH", gold)],
        capture_output=True, text=True, timeout=1800,
        env={"PYTHONPATH": repo, "PATH": "/usr/bin:/bin:/usr/local/bin",
             "HOME": "/root"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, proc.stdout + proc.stderr
    r = json.loads(line[0][len("RESULT "):])
    assert all(r["solved"]), r["solved"]  # every QP certified, no caps
    alpha = 0.2
    assert r["safe"] >= 1 - alpha, r
    assert r["avar"] <= 0.05, r
    # same-quality branch: cost within a modest factor of the x64 golden
    assert r["cost"] <= 3.0 * r["gold_cost"], r
