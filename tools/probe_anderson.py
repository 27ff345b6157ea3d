"""A/B: Anderson acceleration (SolverConfig.anderson_depth) on the
flagship M=1000 SCP solve, bench speed-mode configuration.

Reports per-depth: median wall over perturbed instances, total ADMM
iterations, certification, and MC cost on the canonical instance
(golden band: cost <= ~0.51).

Usage: python tools/probe_anderson.py [depths...]  (default 0 5 10)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from riskaversetrajopt_tpu import runtime

runtime.configure()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

os.environ.setdefault("BENCH_PARITY", "0")
os.environ.setdefault("BENCH_BATCH", "0")
os.environ.setdefault("BENCH_HOPPER", "0")
import bench  # noqa: E402

depths = [int(d) for d in sys.argv[1:]] or [0, 5, 10]
M = int(os.environ.get("BENCH_M", "1000"))
print(f"[probe_anderson] device={jax.devices()[0]} M={M} depths={depths}",
      flush=True)

for d in depths:
    os.environ["BENCH_ANDERSON"] = str(d)
    opt = bench.make(15, "admm", 1e-4, 20000)
    import dataclasses

    opt.admm_cfg = dataclasses.replace(opt.admm_cfg, anderson_depth=d)
    omegas = opt.sample(jax.random.PRNGKey(0), M=M)
    t, res = bench.time_solve(
        opt, omegas, 0.2, jax.devices()[0], 3,
        eps_list=[2.1e-7, 3.2e-7, 4.3e-7],
    )
    total = int(np.sum(np.asarray(res.qp_iters)))
    mc_om = opt.sample(jax.random.PRNGKey(99), M=3000)
    mc = opt.monte_carlo(res.us, mc_om, 0.2)
    print(
        f"[probe_anderson] depth={d} t={t:.4f}s "
        f"({1.0/t:.3f} solves/s) canonical_iters={total} "
        f"qp_iters={res.qp_iters.tolist()} "
        f"solved={int(np.sum(np.asarray(res.qp_solved)))}/15 "
        f"mc_cost={float(mc['cost']):.4f} mc_safe={float(mc['safe_frac']):.4f}",
        flush=True,
    )
