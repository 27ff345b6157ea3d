"""Gaussian drone baseline — parity with drone/drone_gaussian.py: NLP with
risk-allocation variables, warm-started from the SAA solution
(results/drone_alpha=<a>_repeat=0.npy — run drone_risk first, matching the
reference's cross-script contract at drone_gaussian.py:104-116); saves
results/drone_gaussian_alpha=<a>.npy for the drone_risk MC block."""

from __future__ import annotations

import argparse
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from riskaversetrajopt_tpu import runtime
from riskaversetrajopt_tpu.core.config import DroneScenario
from riskaversetrajopt_tpu.experiments import common
from riskaversetrajopt_tpu.models.drone_gaussian import GaussianDronePlanner
from riskaversetrajopt_tpu.ops.nlp_ipm import NLPConfig


def main(argv=None):
    runtime.configure()
    ap = argparse.ArgumentParser()
    ap.add_argument("--alphas", type=float, nargs="+",
                    default=[0.05, 0.1, 0.2, 0.3])
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-iter", type=int, default=1500)
    ap.add_argument("--results", default="results")
    # f32 accelerator path (adds the NLP's symmetric KKT equilibration
    # via the planner's dtype-aware default config)
    ap.add_argument("--dtype", choices=["f64", "f32"], default="f64")
    args = ap.parse_args(argv)

    dtype = jnp.float32 if args.dtype == "f32" else jnp.float64

    rdir = common.results_dir(args.results)
    for alpha in args.alphas:
        warm = rdir / f"drone_alpha={alpha}_repeat=0.npy"
        if not Path(warm).is_file():
            raise FileNotFoundError(
                f"{warm} does not exist.\nrun the drone_risk experiment first."
            )
        us_init, _ = common.load_traj(warm)
        print(f"[drone_gaussian] >>> alpha={alpha}")
        p = GaussianDronePlanner(DroneScenario(), alpha=alpha, dtype=dtype)
        res = p.solve(
            us_init=jnp.asarray(us_init, dtype),
            cfg=NLPConfig(
                tol=args.tol, max_iter=args.max_iter,
                kkt_ruiz_iters=3 if dtype == jnp.float32 else 0,
            ),
        )
        print(f"  iters={int(res.nlp.iters)} solved={bool(res.nlp.solved)} "
              f"prim={float(res.nlp.prim_res):.2e} "
              f"sum(alphas)={float(jnp.sum(res.alphas_risk)):.4f}")
        common.save_traj(
            rdir / f"drone_gaussian_alpha={alpha}.npy", res.us, res.xs
        )


if __name__ == "__main__":
    main()
