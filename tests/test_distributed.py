"""Multi-process distributed backend test (SURVEY.md section 4): a simulated
2-host CPU pod (2 processes x 2 virtual devices, gloo collectives) solves the
sample-sharded structured SAA QP; both processes must agree with each other
AND with the single-process solve in this process. (The full-SCP pod solve is
available via RATO_DIST_FULL=1 on the selftest module — it compiles the whole
SCP scan in every worker and is too slow for CI.)"""

import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riskaversetrajopt_tpu.core.config import SolverConfig
from riskaversetrajopt_tpu.ops.saa_qp import solve_saa_qp
from riskaversetrajopt_tpu.parallel.distributed import selftest_problem


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# Virtual devices per pod process. Every device is a gloo rank, and the
# ADMM solve runs a few cross-rank reductions per iteration: on 8 cores the
# pod takes ~10 s at 1 device per process, ~22 s at 2 and ~72 s at 4, and
# at 4, beside the suite's other workers, it ran past its 600 s limit.
# Two per process keeps an intra-host sample axis on every host.
DEVICES_PER_PROCESS = 2


def _run_pod(extra_env=None):
    port = _free_port()
    env_base = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env_base["PYTHONPATH"] = repo + os.pathsep + env_base.get("PYTHONPATH", "")
    env_base["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEVICES_PER_PROCESS}"
    )
    env_base.update(extra_env or {})
    procs = []
    for pid in range(2):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, "-m",
                    "riskaversetrajopt_tpu.parallel.distributed",
                    "--selftest", "--coordinator", f"localhost:{port}",
                    "--num-processes", "2", "--process-id", str(pid),
                ],
                env=env_base,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
    return outs


def test_two_process_pod_matches_single_process(tmp_path):
    outs = _run_pod()

    sums = []
    for out in outs:
        m = re.search(r"SELFTEST_OK .*ndev=(\d+) us_sum=([-\d.e+]+)", out)
        assert m, f"no SELFTEST_OK in output:\n{out[-3000:]}"
        assert int(m.group(1)) == 2 * DEVICES_PER_PROCESS
        sums.append(float(m.group(2)))
    assert sums[0] == sums[1], "processes disagree on the sharded solution"

    # single-process ground truth on the identical synthetic problem
    st, data = selftest_problem(16)
    data = jax.tree.map(jnp.asarray, data)
    cfg = SolverConfig(eps_abs=1e-8, eps_rel=1e-8, max_iter=8000)
    sol = solve_saa_qp(st, data, jnp.asarray(3), cfg)
    assert bool(sol.solved)
    np.testing.assert_allclose(
        sums[0], float(np.sum(np.asarray(sol.x))), rtol=1e-6
    )


@pytest.mark.slow
def test_two_process_pod_batch_axis_spans_hosts():
    """The (alpha x repeat) sweep axis distributed ACROSS hosts
    (drone_risk.py:498-503): a 2-process pod where the `batch` mesh axis
    coincides with process boundaries solves two independent QP
    instances as one vmapped global program; both processes must agree
    with each other and with the identical vmapped solve run
    single-process."""
    outs = _run_pod({"RATO_DIST_BATCH": "1"})

    per_proc = []
    for out in outs:
        m = re.search(
            r"SELFTEST_BATCH_OK .*ndev=(\d+) "
            r"us_sum0=([-\d.e+]+) us_sum1=([-\d.e+]+)",
            out,
        )
        assert m, f"no SELFTEST_BATCH_OK in output:\n{out[-3000:]}"
        assert int(m.group(1)) == 2 * DEVICES_PER_PROCESS
        per_proc.append((float(m.group(2)), float(m.group(3))))
    assert per_proc[0] == per_proc[1], (
        "processes disagree on the batched solution set"
    )

    # identical vmapped solve, single-process, on this process's devices
    from riskaversetrajopt_tpu.core.config import SolverConfig as _SC

    st, data = selftest_problem(16)
    B = 2
    alphas = np.array([0.1 + 0.2 * b for b in range(B)])
    gups = np.stack([np.asarray(data.g_up) * (1.0 + 0.1 * b)
                     for b in range(B)])
    cfg = _SC(eps_abs=1e-8, eps_rel=1e-8, max_iter=8000, rho_epoch_every=50)

    def one(gup_i, a_i):
        d = jax.tree.map(jnp.asarray, data)._replace(
            g_up=jnp.asarray(gup_i), alpha=jnp.asarray(a_i)
        )
        return solve_saa_qp(st, d, jnp.asarray(3), cfg).x

    xs = jax.vmap(one)(jnp.asarray(gups), jnp.asarray(alphas))
    for b in range(B):
        np.testing.assert_allclose(
            per_proc[0][b], float(np.sum(np.asarray(xs)[b])), rtol=1e-6
        )
