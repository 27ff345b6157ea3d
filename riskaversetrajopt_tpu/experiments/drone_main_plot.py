"""Paper main-figure workload — parity with drone/drone_main_plot.py.

One SAA solve (alpha=0.1, M=50, 20 SCP iterations), Monte Carlo with
M=10000 using the EUCLIDEAN (sqrt) obstacle-constraint variant
(drone_main_plot.py:198-208), VaR by sort-order statistic and AVaR, histogram
of max-constraint values, and the safe/unsafe trajectory figure with
randomized obstacle patches.
"""

from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from riskaversetrajopt_tpu import runtime
from riskaversetrajopt_tpu.core.config import DroneScenario
from riskaversetrajopt_tpu.experiments import common
from riskaversetrajopt_tpu.models.drone import DroneModel
from riskaversetrajopt_tpu.ops.cvar import avar, var_sorted
from riskaversetrajopt_tpu.ops.rollout import rollout
from riskaversetrajopt_tpu.scp.driver import SAATrajOpt


def main(argv=None):
    runtime.configure()
    ap = argparse.ArgumentParser()
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--M", type=int, default=50)
    ap.add_argument("--mc-M", type=int, default=10000)
    ap.add_argument("--scp-iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--results", default="results")
    # f32 for accelerator-only deployments (the reference pins CPU x64)
    ap.add_argument("--dtype", choices=["f64", "f32"], default="f64")
    args = ap.parse_args(argv)

    rdir = common.results_dir(args.results)
    model = DroneModel(DroneScenario(M=args.M))
    scp_cfg = dataclasses.replace(
        model.default_scp_config(), num_iters=args.scp_iters
    )
    opt = SAATrajOpt(
        model, method="saa", scp_cfg=scp_cfg,
        dtype=jnp.float32 if args.dtype == "f32" else jnp.float64,
    )

    print("[drone_main_plot] >>> Computing SAA solution")
    omegas = opt.sample(jax.random.PRNGKey(args.seed), M=args.M)
    res = opt.solve(omegas, alpha=args.alpha)
    common.save_traj(rdir / "drone_main_figure_traj.npy", res.us, res.xs)

    print("[drone_main_plot] >>> Monte Carlo (euclidean constraint variant)")
    mc_om = opt.sample(jax.random.PRNGKey(args.seed + 1), M=args.mc_M)

    def verify(om):
        xs = rollout(model, res.us, om)
        g = model.ineq_constraints_euclidean(xs, om)
        max_c = jnp.max(g)
        return xs, max_c <= model.scn.osqp_tol + 1e-6, max_c

    xs_mc, ok, max_c = jax.vmap(verify)(mc_om)
    safe = float(jnp.mean(ok))
    var_val = float(var_sorted(max_c, args.alpha))
    avar_val = float(avar(max_c, args.alpha))
    print(f"  safe fraction = {safe:.4f}")
    print(f"  VaR_{args.alpha} = {var_val:.4f}  AVaR_{args.alpha} = {avar_val:.4f}")
    with open(rdir / "drone_main_monte_carlo.npy", "wb") as f:
        np.save(f, np.asarray(max_c))
        np.save(f, np.array([safe, var_val, avar_val]))

    if args.plot:
        plt = common.setup_matplotlib()
        fdir = common.figures_dir()
        scn = model.scn
        from matplotlib.patches import Circle

        # trajectory figure with randomized obstacles + safe/unsafe coloring
        fig = plt.figure(figsize=[7, 3.5])
        ok_np = np.asarray(ok)
        xs_np = np.asarray(xs_mc)
        rng = np.random.default_rng(0)
        show = rng.choice(args.mc_M, size=min(150, args.mc_M), replace=False)
        for i in show:
            c = "b" if ok_np[i] else "r"
            plt.plot(xs_np[i, :, 0], xs_np[i, :, 1], c=c, alpha=0.2, lw=0.8)
        for j in range(scn.n_obs):
            for i in show[:40]:
                Q = np.asarray(mc_om.obs_Q[i, j])
                r_eff = 1.0 / np.sqrt(max(Q[0, 0], 1e-9))
                plt.gca().add_patch(
                    Circle(np.asarray(scn.obs_positions[j][:2]), radius=r_eff,
                           color="r", alpha=0.02)
                )
        plt.xlabel("$p_x$")
        plt.ylabel("$p_y$")
        fig.savefig(fdir / "drone_main_figure.png", dpi=150,
                    bbox_inches="tight")

        fig = plt.figure(figsize=[5, 3])
        plt.hist(np.asarray(max_c), bins=80, color="#0C7BDC")
        plt.axvline(var_val, color="k", ls="--", label="VaR")
        plt.axvline(avar_val, color="r", ls="--", label="AVaR")
        plt.legend()
        plt.xlabel("max constraint value")
        fig.savefig(fdir / "drone_main_histogram.png", dpi=150,
                    bbox_inches="tight")
        print("  saved figures")


if __name__ == "__main__":
    main()
