"""Drone SAA workload — parity with drone/drone_risk.py.

Computes SAA solutions over the (alpha x repeat) sweep, the deterministic
baseline, Monte-Carlo validation with AVaR, result persistence in the
reference `.npy` layout, and trajectory plots.

Differences from the reference (all performance, not behavior):
- the full sweep is solved as ONE batched computation (vmapped SCP solves)
  instead of 120 serial script runs (drone_risk.py:498-503);
- figures are saved to figures/ instead of opened in windows.

Usage:
  python -m riskaversetrajopt_tpu.experiments.drone_risk \
      [--alphas 0.05 0.1 0.2 0.3] [--repeats 30] [--M 50] [--scp-iters 60]
      [--skip-saa] [--skip-baseline] [--skip-mc] [--plot]
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from riskaversetrajopt_tpu import runtime
from riskaversetrajopt_tpu.core.config import DroneScenario
from riskaversetrajopt_tpu.experiments import common
from riskaversetrajopt_tpu.models.drone import DroneModel
from riskaversetrajopt_tpu.ops.cvar import avar
from riskaversetrajopt_tpu.scp.driver import SAATrajOpt


def main(argv=None):
    runtime.configure()
    ap = argparse.ArgumentParser()
    ap.add_argument("--alphas", type=float, nargs="+",
                    default=[0.05, 0.1, 0.2, 0.3])
    ap.add_argument("--repeats", type=int, default=30)
    ap.add_argument("--M", type=int, default=50)
    ap.add_argument("--mc-M", type=int, default=10000)
    ap.add_argument("--scp-iters", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-chunk", type=int, default=8,
                    help="repeats solved per batched launch; bounds the "
                         "B x M device footprint (a B=8 x M=1000 fan-out "
                         "in one launch faulted the round-1 device)")
    ap.add_argument("--skip-saa", action="store_true")
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--skip-mc", action="store_true")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--results", default="results")
    # f32 for accelerator-only deployments (the reference pins CPU x64)
    ap.add_argument("--dtype", choices=["f64", "f32"], default="f64")
    args = ap.parse_args(argv)

    dtype = jnp.float32 if args.dtype == "f32" else jnp.float64
    scn = DroneScenario(M=args.M)
    model = DroneModel(scn)
    rdir = common.results_dir(args.results)

    import dataclasses

    scp_cfg = dataclasses.replace(
        model.default_scp_config(), num_iters=args.scp_iters
    )
    opt = SAATrajOpt(model, method="saa", scp_cfg=scp_cfg, dtype=dtype)

    key = jax.random.PRNGKey(args.seed)

    if not args.skip_saa:
        print("[drone_risk] >>> Computing SAA solutions (batched sweep)")
        # all repeats sampled up front (drone_risk.py:480-490)
        keys = jax.random.split(key, args.repeats)
        omegas_all = jax.vmap(lambda k: opt.sample(k, M=args.M))(keys)

        solve_batch = jax.jit(
            jax.vmap(jax.vmap(lambda om, a: opt.solve(om, a), in_axes=(0, None)),
                     in_axes=(None, 0))
        )
        alphas_arr = jnp.asarray(args.alphas, opt.dtype)
        # chunk the repeat axis: bounds the live B x M x K x n Jacobian
        # footprint per launch (one compile serves every chunk)
        chunk = max(1, min(args.batch_chunk, args.repeats))
        parts = []
        for lo in range(0, args.repeats, chunk):
            hi = min(lo + chunk, args.repeats)
            om_part = jax.tree.map(lambda x: x[lo:hi], omegas_all)
            parts.append(solve_batch(om_part, alphas_arr))
        res = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=1), *parts)
        # res.us: (n_alpha, repeats, S, n_u)
        for ia, alpha in enumerate(args.alphas):
            for r in range(args.repeats):
                common.save_traj(
                    rdir / f"drone_alpha={alpha}_repeat={r}.npy",
                    res.us[ia, r], res.xs[ia, r],
                )
        print("  final L2 (median over sweep):",
              float(jnp.median(res.l2_errors[:, :, -1])))

    if not args.skip_baseline:
        print("[drone_risk] >>> Computing baseline solution")
        opt_b = SAATrajOpt(model, method="baseline", scp_cfg=scp_cfg, dtype=dtype,
                           baseline_pad=1e-3)
        om_b = opt_b.sample(jax.random.PRNGKey(args.seed + 1), M=args.M,
                            method="baseline")
        res_b = opt_b.solve(om_b, alpha=0.1)
        common.save_traj(rdir / "drone_baseline.npy", res_b.us, res_b.xs)

    if not args.skip_mc:
        print("[drone_risk] >>> Monte Carlo validation")
        mc_om = opt.sample(jax.random.PRNGKey(args.seed + 2), M=args.mc_M)
        for alpha in args.alphas:
            safes, avars, costs = [], [], []
            for r in range(args.repeats):
                us, _ = common.load_traj(
                    rdir / f"drone_alpha={alpha}_repeat={r}.npy"
                )
                mc = opt.monte_carlo(jnp.asarray(us), mc_om, alpha)
                safes.append(float(mc["safe_frac"]))
                avars.append(float(mc["avar"]))
                costs.append(float(mc["cost"]))
            print(f"  alpha={alpha}: safe(mean)={np.mean(safes):.4f} "
                  f"safe(med)={np.median(safes):.4f} "
                  f"avar(mean)={np.mean(avars):.4f} "
                  f"cost(mean)={np.mean(costs):.4f}")
        try:
            us_b, _ = common.load_traj(rdir / "drone_baseline.npy")
            mc_b = opt.monte_carlo(jnp.asarray(us_b), mc_om, args.alphas[0])
            print(f"  baseline: safe={float(mc_b['safe_frac']):.4f} "
                  f"cost={float(mc_b['cost']):.4f}")
        except FileNotFoundError:
            print("  baseline results missing — run without --skip-baseline")

    if args.plot:
        plt = common.setup_matplotlib()
        fdir = common.figures_dir()
        alpha, r = args.alphas[0], min(1, args.repeats - 1)
        us, xs = common.load_traj(rdir / f"drone_alpha={alpha}_repeat={r}.npy")
        fig = plt.figure(figsize=[6, 3])
        for i in range(min(args.M, xs.shape[0])):
            plt.plot(xs[i, :, 0], xs[i, :, 1], c="b", alpha=0.3)
        from matplotlib.patches import Circle

        for i in range(scn.n_obs):
            plt.gca().add_patch(
                Circle(np.asarray(scn.obs_positions[i][:2]),
                       radius=float(scn.obs_radii[i]), color="r", alpha=0.3)
            )
        plt.scatter(*np.asarray(scn.x_init[:2]), color="k")
        plt.scatter(*np.asarray(scn.x_final[:2]), color="k")
        plt.xlabel("$p_x$")
        plt.ylabel("$p_y$")
        fig.savefig(fdir / "drone_risk_trajectories.png", dpi=150,
                    bbox_inches="tight")
        print("  saved", fdir / "drone_risk_trajectories.png")


if __name__ == "__main__":
    main()
