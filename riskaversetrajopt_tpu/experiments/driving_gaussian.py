"""Gaussian car baseline — parity with car/driving_gaussian.py: SCP with
quantile back-off chance constraints and optimal risk allocation; saves
results/driving_gaussian_alpha=<a>.npy consumed by the driving MC block."""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from riskaversetrajopt_tpu import runtime
from riskaversetrajopt_tpu.core.config import CarScenario
from riskaversetrajopt_tpu.experiments import common
from riskaversetrajopt_tpu.models.car_gaussian import GaussianCarPlanner


def main(argv=None):
    runtime.configure()
    ap = argparse.ArgumentParser()
    ap.add_argument("--alphas", type=float, nargs="+",
                    default=[0.01, 0.02, 0.05, 0.1])
    ap.add_argument("--scp-iters", type=int, default=60)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--results", default="results")
    # f32 accelerator path: the 1e-8-tolerance QPs run through the
    # iterative-refinement solve (models/car_gaussian.py qp_refine path)
    ap.add_argument("--dtype", choices=["f64", "f32"], default="f64")
    args = ap.parse_args(argv)

    dtype = jnp.float32 if args.dtype == "f32" else jnp.float64

    rdir = common.results_dir(args.results)
    for alpha in args.alphas:
        print(f"[driving_gaussian] >>> alpha={alpha}")
        p = GaussianCarPlanner(CarScenario(), alpha=alpha,
                               num_scp_iters=args.scp_iters, dtype=dtype)
        res = jax.jit(p.solve)()
        print(f"  L2 final={float(res.l2_errors[-1]):.2e} "
              f"sum(alphas_risk)={float(jnp.sum(res.alphas_risk)):.4f}")
        common.save_traj(
            rdir / f"driving_gaussian_alpha={alpha}.npy", res.us, res.xs
        )

    if args.plot:
        plt = common.setup_matplotlib()
        fdir = common.figures_dir()
        alpha = args.alphas[0]
        us, xs = common.load_traj(rdir / f"driving_gaussian_alpha={alpha}.npy")
        p = GaussianCarPlanner(CarScenario(), alpha=alpha)
        Sigmas = np.asarray(p.covariance_trajectory(jnp.asarray(us)))
        fig = plt.figure(figsize=[6, 3])
        plt.plot(xs[:, 0], xs[:, 1], "b-+")
        from matplotlib.patches import Ellipse

        for t in range(1, xs.shape[0]):
            Sig = Sigmas[t][4:6, 4:6]
            vals, vecs = np.linalg.eigh(Sig)
            ang = np.degrees(np.arctan2(vecs[1, 0], vecs[0, 0]))
            w, h = 2 * np.sqrt(np.maximum(vals, 0) * 4.6)  # ~90% chi2
            plt.gca().add_patch(
                Ellipse(xs[t, 4:6], w, h, angle=ang, color="g", alpha=0.15)
            )
        plt.plot(xs[:, 4], xs[:, 5], "g.")
        plt.xlabel("$p^x$")
        plt.ylabel("$p^y$")
        fig.savefig(fdir / "driving_gaussian.png", dpi=150,
                    bbox_inches="tight")
        print("  saved", fdir / "driving_gaussian.png")


if __name__ == "__main__":
    main()
