"""Probe: post-gating transition-QP cost vs the rho it restarts from.

In the speed mode at M=1000 the transition QP (scp_iter == gate_iters,
where the 1e-7-gated obstacle rows come live, drone_risk.py:413-417) takes
most of the solve's ADMM iterations (qp_iters in bench.py's speed record) —
its warm y is ~0 on the newly-live rows, so it is effectively a cold start
whose iteration count is governed by the rho trajectory.
`scp/driver._warm_rho` restarts that QP from cfg.rho (0.1, the OSQP
default); this probe sweeps the restart value.

Usage: python tools/probe_transition_rho.py [rho ...]   (default sweep)
Env: BENCH_M, BENCH_ITERS (reused from bench.make).
"""

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402


def main():
    rhos = [float(a) for a in sys.argv[1:]] or [0.02, 0.05, 0.1, 0.3, 1.0, 3.0]
    M = int(os.environ.get("BENCH_M", "1000"))
    iters = int(os.environ.get("BENCH_ITERS", "15"))
    opt0 = bench.make(iters, "admm", 1e-4, 20000)
    omegas = opt0.sample(jax.random.PRNGKey(0), M=M)
    dev = jax.devices()[0]
    for rho in rhos:
        opt = bench.make(iters, "admm", 1e-4, 20000)
        opt.admm_cfg = dataclasses.replace(opt.admm_cfg, rho=rho)
        t, res = bench.time_solve(opt, omegas, 0.2, dev, 3)
        qi = res.qp_iters.tolist()
        print(
            f"[probe] rho={rho:<5} t={t:.4f}s total_iters={sum(qi)} "
            f"transition={qi[2]} qp_iters={qi} "
            f"solved={int(np.sum(np.asarray(res.qp_solved)))}/{len(qi)} "
            f"l2_final={float(res.l2_errors[-1]):.2e}",
            flush=True,
        )


if __name__ == "__main__":
    main()
