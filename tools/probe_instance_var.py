"""Probe: per-instance wall time vs ADMM iteration counts (speed mode).

If the transition-rho sweep (probe_transition_rho.py) shows ~flat wall time
across a wide spread in the CANONICAL instance's total ADMM iterations, either (a) perturbed timed instances take far fewer
iterations than the canonical seed-0 instance (branch sensitivity of the
post-gating transition QP), or (b) the solve is overhead-dominated. This
probe times N perturbed instances INDIVIDUALLY and reports each one's
qp_iters, separating the two hypotheses.

Usage: python tools/probe_instance_var.py [rho ...]
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
    rhos = [float(a) for a in sys.argv[1:]] or [0.1, 0.05]
    M = int(os.environ.get("BENCH_M", "1000"))
    iters = int(os.environ.get("BENCH_ITERS", "15"))
    N = int(os.environ.get("PROBE_N", "6"))
    dev = jax.devices()[0]
    for rho in rhos:
        opt = bench.make(iters, "admm", 1e-4, 20000)
        opt.admm_cfg = dataclasses.replace(opt.admm_cfg, rho=rho)
        omegas = opt.sample(jax.random.PRNGKey(0), M=M)
        om0 = jax.tree.map(lambda x: jax.device_put(x, dev), omegas)
        r = opt.solve(bench._perturb(om0), 0.2)  # compile + warm
        np.asarray(r.us)
        for i in range(N):
            om_i = bench._perturb(om0)
            t0 = time.perf_counter()
            r = opt.solve(om_i, 0.2)
            np.asarray(r.us)
            t = time.perf_counter() - t0
            qi = r.qp_iters.tolist()
            print(
                f"[probe] rho={rho} inst={i} t={t:.4f}s total={sum(qi)} "
                f"transition={qi[2]} solved="
                f"{int(np.sum(np.asarray(r.qp_solved)))}/{len(qi)}",
                flush=True,
            )


if __name__ == "__main__":
    main()
