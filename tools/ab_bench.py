"""A/B the speed-mode solver knobs on hardware at M=1000.

Configs swept: kkt_refine_mode (true | factored), check_backoff_max (1 | 8),
polish (on | off). Each config reports median solve time over never-seen
perturbed instances (see bench._perturb: the runtime result-caches repeat
executions), total ADMM iterations, certification, l2_vs_golden and MC cost.

Run detached:  setsid nohup python -u tools/ab_bench.py > /tmp/ab.log 2>&1 &
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from riskaversetrajopt_tpu import runtime  # noqa: E402

runtime.configure()

from bench import _perturb, make  # noqa: E402

M = int(os.environ.get("AB_M", "1000"))
ITERS = int(os.environ.get("AB_ITERS", "15"))
REPEATS = int(os.environ.get("AB_REPEATS", "3"))


def run_cfg(name, **kw):
    import dataclasses

    opt = make(ITERS, "admm", 1e-4, 20000)
    opt.admm_cfg = dataclasses.replace(opt.admm_cfg, **kw)
    omegas = opt.sample(jax.random.PRNGKey(0), M=M)
    alpha = 0.2
    dev = jax.devices()[0]
    om = jax.tree.map(lambda x: jax.device_put(x, dev), omegas)
    a = jax.device_put(jnp.asarray(alpha, jnp.float32), dev)
    res = opt.solve(_perturb(om), a)  # compile+warm
    np.asarray(res.us)
    times = []
    for _ in range(REPEATS):
        om_i = _perturb(om)
        t0 = time.perf_counter()
        r = opt.solve(om_i, a)
        np.asarray(r.us)
        times.append(time.perf_counter() - t0)
    times.sort()
    t = times[len(times) // 2]
    res = opt.solve(om, a)  # canonical (possibly cached, not timed)
    np.asarray(res.us)
    gold_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "fixtures", f"gold_drone_m{M}_a{alpha}_seed0_iters{ITERS}.npy",
    )
    l2g = None
    if os.path.exists(gold_path):
        gold = np.load(gold_path)
        us = np.asarray(res.us)
        l2g = float(np.linalg.norm(us - gold) / np.linalg.norm(gold))
    mc_om = opt.sample(jax.random.PRNGKey(99), M=3000)
    mc = opt.monte_carlo(res.us, mc_om, a)
    print(
        f"[ab] {name:28s} t={t:.4f}s solves/s={1.0/t:.4f} "
        f"qp_iters_total={int(np.sum(res.qp_iters))} "
        f"capped={int(np.sum(np.asarray(res.qp_iters) >= 20000))} "
        f"solved_all={bool(np.all(res.qp_solved))} "
        f"l2_vs_golden={l2g} mc_safe={float(mc['safe_frac']):.4f} "
        f"mc_cost={float(mc['cost']):.4f}",
        flush=True,
    )
    return t


def main():
    print(f"[ab] device={jax.devices()[0]} M={M} iters={ITERS}", flush=True)
    run_cfg("baseline (true,cb1,polish)")
    run_cfg("factored", kkt_refine_mode="factored")
    run_cfg("backoff8", check_backoff_max=8)
    run_cfg("factored+backoff8", kkt_refine_mode="factored",
            check_backoff_max=8)
    run_cfg("nopolish", polish=False)
    run_cfg("factored+backoff8+nopolish", kkt_refine_mode="factored",
            check_backoff_max=8, polish=False)


if __name__ == "__main__":
    main()
