"""Probe: hopper COLD baseline NLP solve in true f32.

Round-3 finding (PARITY.md, f32 hopper): the cold f32 solve departs
into a poor local basin (jump ~0.02-0.03 vs x64's 1.053) during the first
few large barrier steps. Round-4 candidates under test here:
  - kkt_ds_refine_iters: compensated (double-single) iterative refinement
    on the augmented-KKT LU solve (accurate Newton directions from f32-only
    arithmetic),
  - damp_iters/damp_max: first-steps fraction-to-boundary damping.

IMPORTANT dtype honesty: with jax_enable_x64=True the model closures
compute in f64 even when Z is f32 (silent promotion inside g_fn), so the
all-f32 variants MUST run in a process with x64 DISABLED. This script runs
ONE variant per invocation:

    python tools/probe_hopper_f32.py x64                 # reference basin
    python tools/probe_hopper_f32.py f32 [knob=val ...]  # true-f32 variant

knobs: ruiz, ds, damp_iters, damp_max, merit_comp, soc, iters, tol, mu_init
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

mode = sys.argv[1] if len(sys.argv) > 1 else "f32"
kw = {}
for a in sys.argv[2:]:
    k, v = a.split("=")
    kw[k] = v

if mode == "x64":
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from riskaversetrajopt_tpu.core.config import HopperScenario  # noqa: E402
from riskaversetrajopt_tpu.models.hopper import HopperModel  # noqa: E402
from riskaversetrajopt_tpu.ops.nlp_ipm import NLPConfig, solve_nlp  # noqa: E402


def main():
    model = HopperModel(HopperScenario())
    field = model.sample_friction(jax.random.PRNGKey(1), model.M, "baseline")
    f, g, gL, gU, n_eq, xL, xU = model.make_nlp(field, "baseline", 0.1)
    Z0 = model.initial_guess(model.M)
    print(f"[probe] mode={mode} kw={kw} dtype={Z0.dtype} "
          f"n={Z0.shape[0]} m={gL.shape[0]}", flush=True)

    cfg = NLPConfig(
        tol=float(kw.get("tol", "1e-4")),
        max_iter=int(kw.get("iters", "1500")),
        mu_init=float(kw.get("mu_init", "1e-1")),
        kkt_ruiz_iters=int(kw.get("ruiz", "3" if mode == "f32" else "0")),
        kkt_ds_refine_iters=int(kw.get("ds", "0")),
        damp_iters=int(kw.get("damp_iters", "0")),
        damp_max=float(kw.get("damp_max", "0.1")),
        merit_compensated=bool(int(kw.get("merit_comp", "0"))),
        soc=bool(int(kw.get("soc", "0"))),
    )
    t0 = time.time()
    res = solve_nlp(f, g, gL, gU, n_eq, xL, xU, Z0, cfg)
    res = jax.block_until_ready(res)
    xs, us, ys, slack, t_risk = model.split_z(res.Z)
    print(
        f"[probe] RESULT iters={int(res.iters)} solved={bool(res.solved)} "
        f"prim={float(res.prim_res):.3e} dual={float(res.dual_res):.3e} "
        f"comp={float(res.comp_res):.3e} jump={float(xs[-1, 0]):.4f} "
        f"f={float(res.f_val):.6g} wall={time.time() - t0:.1f}s",
        flush=True,
    )


if __name__ == "__main__":
    main()
