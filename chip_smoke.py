"""Bring-up check of the solve path on one GPU, through the user entry points.

    python chip_smoke.py                # one card: drone_f64, drone_f32, hopper_f64
    python chip_smoke.py --four-cards   # four cards: the sample-sharded f64 solve

Every phase runs in this one process (a JAX process reserves most of a
card's memory, so a second one could not open it) and prints one line with
its checks and wall times. The last line of standard output is the JSON
result `{"ok": true, "device": {...}}`; any failed check, and a run that finds
no GPU, exits non-zero before that line is printed.

Phases (each an importable function that takes its sizes, so the CPU tests
run them at tiny M):

- `drone_f64`: the flagship, `SAATrajOpt.solve` with the library's default
  `admm` configuration in f64 on `DroneModel(DroneScenario(M=1000))`, seed 0,
  alpha 0.2, 15 SCP iterations; relative L2 <= 1e-3 against the committed
  golden, every QP certified and none capped, Monte-Carlo safety and cost on
  10,000 fresh samples next to the golden's on the same samples.
- `drone_f32`: the bench's speed configuration (`bench.make`) on the same
  instance in true f32 (x64 off for the phase); MC quality against the golden.
- `hopper_f64`: the NLP entry point (`ops.nlp_ipm.solve_nlp`): the damped
  cold baseline, then the warm-started SAA solve at M=30, alpha 0.3.
- `four_cards` (only with `--four-cards`): the f64 flagship with its samples
  sharded over a 4-device `samples` mesh, against the golden and against a
  one-card solve of the same instance on device 0.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from riskaversetrajopt_tpu import runtime
from riskaversetrajopt_tpu.core.config import DroneScenario, HopperScenario, SCPConfig
from riskaversetrajopt_tpu.models.drone import DroneModel
from riskaversetrajopt_tpu.models.hopper import HopperModel
from riskaversetrajopt_tpu.scp.driver import SAATrajOpt

FIXTURES = pathlib.Path(__file__).resolve().parent / "tests" / "fixtures"
ALPHA = 0.2  # the committed goldens' risk level
# Gates. f64: the x64 CPU path lands 1.6-2.2e-4 from the goldens, and MC on
# the same fresh samples then matches the golden's almost exactly. f32: the
# SCP takes another branch through the degenerate post-gating QPs, so only
# solution quality is gated (at M=50 on the CPU: safe +0.019, cost +1.3%).
L2_TOL = 1e-3
F64_SAFE_TOL, F64_COST_RTOL = 0.005, 0.01
F32_SAFE_DROP, F32_COST_RTOL = 0.02, 0.10
# hopper: the converged x64 baseline (tests/fixtures/hopper_base_Z.npy)
HOPPER_ALPHA, HOPPER_BASE_JUMP, HOPPER_JUMP_TOL = 0.3, 1.0534, 1e-2


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


@contextlib.contextmanager
def x64(enabled: bool):
    """Set jax_enable_x64 for a phase and restore it afterwards. Models and
    samples are built inside the phase, so their constants take its dtype."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def golden(M: int = 1000, num_iters: int = 15) -> np.ndarray:
    return np.load(FIXTURES / f"gold_drone_m{M}_a{ALPHA}_seed0_iters{num_iters}.npy")


def rel_l2(us, ref) -> float:
    us, ref = np.asarray(us, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(us - ref) / np.linalg.norm(ref))


def peak_bytes():
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def report(name: str, checks: dict, fields: dict) -> dict:
    """Print the phase's line; raise if any check failed."""
    ok = all(checks.values())
    print(f"[{name}] {'PASS' if ok else 'FAIL'} "
          + json.dumps({"checks": checks, **fields}), flush=True)
    if not ok:
        failed = [k for k, v in checks.items() if not v]
        raise SmokeFailure(f"phase {name} failed: {failed}")
    return fields


def timed_solves(opt, omegas, alpha):
    """(result, first call s, warm call s): the first call compiles; the
    second is one warm solve, ended by block_until_ready."""
    t0 = time.perf_counter()
    res = jax.block_until_ready(opt.solve(omegas, alpha))
    t1 = time.perf_counter()
    res = jax.block_until_ready(opt.solve(omegas, alpha))
    t2 = time.perf_counter()
    return res, t1 - t0, t2 - t1


def drone_scp_cfg(num_iters: int) -> SCPConfig:
    # test_drone_golden_trajectory_parity_m1000's set-up
    return SCPConfig(num_iters=num_iters, gate_iters=2, gate_row_scale=1e-7,
                     gate_bound_l=-0.1, gate_bound_u=0.1)


def drone_instance(M: int, mc_M: int):
    """The golden's instance (PRNGKey(0)) and the MC samples (PRNGKey(99)),
    drawn in f64 as numpy arrays, so every phase solves the same problem."""
    with x64(True):
        model = DroneModel(DroneScenario(M=M))
        om = jax.tree.map(np.asarray, model.sample(jax.random.PRNGKey(0), M=M))
        mc = jax.tree.map(np.asarray, model.sample(jax.random.PRNGKey(99), M=mc_M))
    return om, mc


def solve_summary(res, warm_s):
    qp_iters = [int(v) for v in np.asarray(res.qp_iters)]
    return {
        "qp_iters": qp_iters,
        "qp_iters_total": sum(qp_iters),
        # the bar a future Hopper kernel must beat end to end
        "admm_us_per_iter": 1e6 * warm_s / max(1, sum(qp_iters)),
    }


def mc_pair(opt, us, gold, mc_om):
    mc = opt.monte_carlo(us, mc_om, ALPHA)
    mcg = opt.monte_carlo(jnp.asarray(gold, opt.dtype), mc_om, ALPHA)
    return {
        "mc_safe": float(mc["safe_frac"]), "mc_safe_golden": float(mcg["safe_frac"]),
        "mc_cost": float(mc["cost"]), "mc_cost_golden": float(mcg["cost"]),
        "mc_avar": float(mc["avar"]), "mc_avar_golden": float(mcg["avar"]),
    }


def phase_drone_f64(M=1000, num_iters=15, mc_M=10000, gold=None) -> dict:
    gold = golden(M, num_iters) if gold is None else gold
    om_np, mc_np = drone_instance(M, mc_M)
    with x64(True):
        model = DroneModel(DroneScenario(M=M))
        opt = SAATrajOpt(model, method="saa", scp_cfg=drone_scp_cfg(num_iters))
        om = jax.tree.map(jnp.asarray, om_np)
        res, first_s, warm_s = timed_solves(opt, om, ALPHA)
        max_iter = opt.admm_cfg.max_iter
        f = {"M": M, "dtype": str(res.us.dtype),
             "l2_vs_golden": rel_l2(res.us, gold),
             **solve_summary(res, warm_s),
             **mc_pair(opt, res.us, gold, jax.tree.map(jnp.asarray, mc_np))}
    solved = [bool(v) for v in np.asarray(res.qp_solved)]
    checks = {
        f"l2_vs_golden<={L2_TOL:g}": f["l2_vs_golden"] <= L2_TOL,
        "all_qp_solved": all(solved),
        "none_capped": all(i < max_iter for i in f["qp_iters"]),
        f"|mc_safe-golden|<={F64_SAFE_TOL:g}":
            abs(f["mc_safe"] - f["mc_safe_golden"]) <= F64_SAFE_TOL,
        f"|mc_cost/golden-1|<={F64_COST_RTOL:g}":
            abs(f["mc_cost"] / f["mc_cost_golden"] - 1) <= F64_COST_RTOL,
    }
    f.update(compile_and_first_s=first_s, warm_s=warm_s,
             peak_bytes_in_use=peak_bytes())
    return report("drone_f64", checks, f)


def phase_drone_f32(M=1000, num_iters=15, mc_M=10000, gold=None) -> dict:
    import bench

    gold = golden(M, num_iters) if gold is None else gold
    om_np, mc_np = drone_instance(M, mc_M)
    with x64(False):
        opt = bench.make(num_iters, "admm", 1e-4, 20000)
        def f32(tree):
            return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tree)

        om = f32(om_np)
        G = jax.eval_shape(
            lambda o: opt._define(opt.model.initial_guess(), o, ALPHA, M), om
        ).G
        res, first_s, warm_s = timed_solves(opt, om, ALPHA)
        max_iter = opt.admm_cfg.max_iter
        f = {"M": M, "dtype": str(res.us.dtype), "G_dtype": str(G.dtype),
             # not gated: f32 SCP takes another branch through the
             # degenerate post-gating QPs (PARITY.md)
             "l2_vs_golden": rel_l2(res.us, gold),
             **solve_summary(res, warm_s),
             **mc_pair(opt, res.us, gold, f32(mc_np))}
    solved = [bool(v) for v in np.asarray(res.qp_solved)]
    checks = {
        "float32": f["dtype"] == "float32" and f["G_dtype"] == "float32",
        "all_qp_solved": all(solved),
        "none_capped": all(i < max_iter for i in f["qp_iters"]),
        f"mc_safe>=golden-{F32_SAFE_DROP:g}":
            f["mc_safe"] >= f["mc_safe_golden"] - F32_SAFE_DROP,
        f"|mc_cost/golden-1|<={F32_COST_RTOL:g}":
            abs(f["mc_cost"] / f["mc_cost_golden"] - 1) <= F32_COST_RTOL,
    }
    f.update(compile_and_first_s=first_s, warm_s=warm_s,
             peak_bytes_in_use=peak_bytes())
    return report("drone_f32", checks, f)


def phase_hopper_f64(M=30, mc_M=10000) -> dict:
    from riskaversetrajopt_tpu.experiments.hopper import no_slip_violation
    from riskaversetrajopt_tpu.ops.nlp_ipm import NLPConfig, classify_rows, solve_nlp

    def jitted(model, field, method, a, cfg):
        fp, gp, params, gL, gU, n_eq, xL, xU = model.make_nlp_params(field, method, a)
        row_perm = classify_rows(gL, gU, n_eq)
        fn = jax.jit(lambda Z, p: solve_nlp(fp, gp, gL, gU, n_eq, xL, xU, Z,
                                             cfg, params=p, row_perm=row_perm))
        return fn, params

    with x64(True):
        model = HopperModel(HopperScenario(M=M))
        s = model.scn
        # damped cold baseline from the teleporting initial guess
        base, p_b = jitted(
            model, model.sample_friction(jax.random.PRNGKey(1), M, "baseline"),
            "baseline", 0.1,
            NLPConfig(tol=1e-4, max_iter=300, damp_iters=50, damp_max=0.1,
                      kkt_ruiz_iters=3),
        )
        t0 = time.perf_counter()
        res_b = jax.block_until_ready(base(model.initial_guess(M), p_b))
        t_base = time.perf_counter() - t0
        xs_b, us_b, *_ = model.split_z(res_b.Z)
        # warm-started SAA solve (the reference's two-phase workflow)
        n_xs, n_us = (s.S + 1) * s.n_x, s.S * s.n_u
        Z0 = jnp.zeros(n_xs + n_us + M + 2)
        Z0 = Z0.at[:n_xs].set(xs_b.reshape(-1)).at[n_xs:n_xs + n_us].set(us_b.reshape(-1))
        saa, p_s = jitted(
            model, model.sample_friction(jax.random.PRNGKey(2), M, "saa"),
            "saa", HOPPER_ALPHA,
            NLPConfig(tol=1e-3, max_iter=500, kkt_ruiz_iters=3),
        )
        t0 = time.perf_counter()
        res_s = jax.block_until_ready(saa(Z0, p_s))
        t_saa_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_s = jax.block_until_ready(saa(Z0, p_s))
        t_saa_warm = time.perf_counter() - t0
        xs_s, us_s, *_ = model.split_z(res_s.Z)
        mc_field = model.sample_friction(jax.random.PRNGKey(99), mc_M, "saa")
        viol = no_slip_violation(model, xs_s, us_s, mc_field)
        f = {
            "M": M, "alpha": HOPPER_ALPHA, "dtype": str(res_s.Z.dtype),
            "baseline_iters": int(res_b.iters), "baseline_jump": float(xs_b[-1, 0]),
            "saa_iters": int(res_s.iters), "saa_jump": float(xs_s[-1, 0]),
            "mc_safe": float(jnp.mean(viol <= 1e-6)),
        }
    checks = {
        "baseline_solved": bool(res_b.solved),
        "saa_solved": bool(res_s.solved),
        f"|baseline_jump-{HOPPER_BASE_JUMP}|<={HOPPER_JUMP_TOL:g}":
            abs(f["baseline_jump"] - HOPPER_BASE_JUMP) <= HOPPER_JUMP_TOL,
        f"mc_safe>={1 - HOPPER_ALPHA:g}": f["mc_safe"] >= 1 - HOPPER_ALPHA,
    }
    f.update(baseline_compile_and_solve_s=t_base,
             saa_compile_and_first_s=t_saa_first, saa_warm_s=t_saa_warm,
             peak_bytes_in_use=peak_bytes())
    return report("hopper_f64", checks, f)


def phase_four_cards(M=1000, num_iters=15, n_devices=4, gold=None) -> dict:
    from riskaversetrajopt_tpu.parallel.mesh import make_mesh, shard_samples

    gold = golden(M, num_iters) if gold is None else gold
    om_np, _ = drone_instance(M, 1)
    with x64(True):
        model = DroneModel(DroneScenario(M=M))
        mesh = make_mesh(n_sample_devices=n_devices)
        sharded = SAATrajOpt(model, method="saa", scp_cfg=drone_scp_cfg(num_iters),
                             sample_pin=(mesh, "samples"))
        om_sh = shard_samples(jax.tree.map(jnp.asarray, om_np), mesh)
        res_sh, first_sh, warm_sh = timed_solves(sharded, om_sh, ALPHA)
        one = SAATrajOpt(model, method="saa", scp_cfg=drone_scp_cfg(num_iters))
        om_1 = jax.device_put(jax.tree.map(jnp.asarray, om_np), jax.devices()[0])
        res_1, first_1, warm_1 = timed_solves(one, om_1, ALPHA)
        f = {"M": M, "devices": n_devices,
             "l2_vs_golden": rel_l2(res_sh.us, gold),
             "l2_vs_one_card": rel_l2(res_sh.us, res_1.us),
             "one_card_l2_vs_golden": rel_l2(res_1.us, gold),
             "qp_iters_sharded": [int(v) for v in np.asarray(res_sh.qp_iters)],
             "qp_iters_one_card": [int(v) for v in np.asarray(res_1.qp_iters)]}
    checks = {
        f"l2_vs_golden<={L2_TOL:g}": f["l2_vs_golden"] <= L2_TOL,
        f"l2_vs_one_card<={L2_TOL:g}": f["l2_vs_one_card"] <= L2_TOL,
        "all_qp_solved": bool(np.all(np.asarray(res_sh.qp_solved))),
    }
    f.update(sharded_compile_and_first_s=first_sh, sharded_warm_s=warm_sh,
             one_card_compile_and_first_s=first_1, one_card_warm_s=warm_1)
    return report("four_cards", checks, f)


def header() -> str:
    import jaxlib

    d = runtime.device_record()
    return "[header] " + json.dumps({
        "jax": jax.__version__, "jaxlib": jaxlib.__version__,
        **d,
        "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
        "matmul_precision": jax.config.jax_default_matmul_precision,
        "compile_cache_dir": jax.config.jax_compilation_cache_dir,
    })


def result_line() -> str:
    d = jax.devices()[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sample-sharded solve and its one-card comparison")
    args = ap.parse_args(argv)
    runtime.require_gpu()
    runtime.configure()
    print(runtime.card_info(), flush=True)  # nvidia-smi's "name, power.limit"
    print(header(), flush=True)
    t0 = time.perf_counter()
    if args.four_cards:
        if len(jax.devices()) < 4:
            raise SmokeFailure(f"--four-cards needs 4 devices, found {len(jax.devices())}")
        phase_four_cards()
    else:
        phase_drone_f64()
        phase_drone_f32()
        phase_hopper_f64()
    print(f"[total] {time.perf_counter() - t0:.1f} s", flush=True)
    print(result_line(), flush=True)


if __name__ == "__main__":
    sys.exit(main())
