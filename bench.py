"""Benchmark: drone_risk SAA SCP at M=1000 samples, full horizon, on one GPU.

Every leg runs in this one process, one after another (a JAX process
reserves most of the card's memory, so a child process could not open it),
and prints its JSON record on its own line as soon as it is measured. Every
record names the device (`platform`, `device_kind`, `device_count`, and the
card's name and power limit from nvidia-smi). A run that finds no GPU exits
non-zero; a leg that fails exits non-zero after the records already printed.

Legs, in order:

- `speed` (the headline): full SCP solves per second. One solve = 15 SCP
  iterations of linearize + CVaR-pack + QP solve at M=1000 in f32, the
  BASELINE.md configuration; the reference runs the same loop as JAX-CPU-x64
  define + OSQP solve per iteration (car/driving.py:486-513). Extras:
  qp_iters (per-SCP-iteration ADMM counts, none may sit at the max_iter
  cap), qp_solved, l2_final (SCP step change), l2_vs_golden, and
  out-of-sample Monte-Carlo quality (safe fraction / AVaR / cost) next to the
  x64 golden trajectory's own numbers on the same fresh samples. The f32 SCP
  takes another branch through the degenerate post-gating QPs than the x64
  golden (PARITY.md), so l2_vs_golden is reported, not gated.
- `host_cpu`: the same jitted computation on this host's CPU backend, on the
  same never-seen instances. A CPU time, not a device metric.
- `parity`: the golden-branch certified configuration (admm-ir:
  eps_rel 1e-5 + compensated iterative refinement).
- `batched`: 30 instances at M=50 vmapped in lockstep, and `solve_many` over
  BENCH_SCAN_B instances at M=1000, each against its serial rate.
- `ds`: the double-single ADMM backend at eps 1e-6.
- `hopper`: the NLP engine (ops/nlp_ipm.py) in f32: damped cold baseline,
  then warm-started SAA solves at M=30 and BENCH_HOPPER_SCALED_M.

Env knobs: BENCH_M, BENCH_ITERS, BENCH_REPEATS, BENCH_BACKEND
(admm | admm-ds | hybrid | ipm), BENCH_EPS, BENCH_MAX_ITER, BENCH_MC_M,
BENCH_KKT_REFINE, BENCH_KKT_REFINE_MODE (true | factored),
BENCH_SWEEP_PRECISION (highest | high), BENCH_RHO_EPOCH, BENCH_POLISH,
BENCH_EPS_REL, BENCH_BATCH, BENCH_BATCH_M, BENCH_SCAN_B, BENCH_PARITY,
BENCH_DS, BENCH_HOPPER, BENCH_HOPPER_SCALED_M.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from riskaversetrajopt_tpu import runtime

GOLD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "fixtures")


def make(num_iters, backend, eps, max_iter, eps_rel=None, ir_cfg=None,
         polish=None, refine_mode=None, rho_ws=None, kkt_inv=None):
    """The bench's solver facade; the defaults are the speed configuration."""
    from riskaversetrajopt_tpu.core.config import (
        DroneScenario,
        SCPConfig,
        SolverConfig,
    )
    from riskaversetrajopt_tpu.models.drone import DroneModel
    from riskaversetrajopt_tpu.scp.driver import SAATrajOpt

    model = DroneModel(DroneScenario())
    return SAATrajOpt(
        model,
        method="saa",
        scp_cfg=SCPConfig(
            num_iters=num_iters,
            gate_iters=2,
            gate_row_scale=1e-7,
            gate_bound_l=-0.1,
            gate_bound_u=0.1,
        ),
        qp_backend=backend,
        admm_cfg=SolverConfig(
            eps_abs=eps,
            eps_rel=float(
                os.environ.get("BENCH_EPS_REL", eps if eps_rel is None
                               else eps_rel)
            ),
            max_iter=max_iter,
            polish=(
                bool(int(os.environ.get("BENCH_POLISH", "1")))
                if polish is None else polish
            ),
            kkt_refine_iters=int(os.environ.get("BENCH_KKT_REFINE", "1")),
            # "factored" + compensated factor formation: 2 G-sweeps per
            # iteration instead of 4, with every QP still certified at
            # M=1000 (PARITY.md round 3)
            kkt_refine_mode=(
                os.environ.get("BENCH_KKT_REFINE_MODE", "factored")
                if refine_mode is None else refine_mode
            ),
            sweep_precision=os.environ.get("BENCH_SWEEP_PRECISION", "highest"),
            # fixed-cadence rho epochs (0 = event-driven); see
            # SolverConfig.rho_epoch_every
            rho_epoch_every=int(os.environ.get("BENCH_RHO_EPOCH", "0")),
            # 1.5: eager rho tracking — refactorizing the structured Schur
            # KKT is cheap. Sweep at M=1000: factor 5/3/2/1.5 took
            # 13900/11975/10525/9575 ADMM iterations (1.2 destabilizes:
            # 16700; PARITY.md round 3)
            rho_update_factor=1.5,
            # speed mode opts into cross-QP rho warm starts (gate-aware;
            # scp/driver._warm_rho) — the library default is off for golden
            # branch-tracking parity
            rho_warm_start=True if rho_ws is None else rho_ws,
            # per-iteration Schur solve through the precomputed explicit
            # inverse (SolverConfig.kkt_chol_inverse); same iteration counts
            # and MC quality as the triangular solves (PARITY.md round 4)
            kkt_chol_inverse=True if kkt_inv is None else kkt_inv,
        ),
        ir_cfg=ir_cfg,
        dtype=jnp.float32,
    )


def _perturb(omegas, eps=None):
    """Tiny multiplicative input perturbation with a random factor (~1e-7
    relative), so that every timed instance is one no cache has seen."""
    import secrets

    if eps is None:
        eps = (1.0 + secrets.randbelow(10**9) / 1e9) * 1e-7
    return jax.tree.map(lambda x: x * (1.0 + eps), omegas)


def time_solve(opt, omegas, alpha, device, repeats, eps_list=None,
               want_result=True):
    """Median solve time over `repeats` never-seen (randomly perturbed)
    problem instances, with the result MATERIALIZED TO HOST inside the
    timed region. The returned result object is the canonical (unperturbed)
    solve, excluded from timing. Pass the same `eps_list` to compare devices
    on identical instances (per-instance difficulty varies)."""
    if eps_list is None:
        eps_list = [None] * repeats
    with jax.default_device(device):
        om = jax.tree.map(lambda x: jax.device_put(x, device), omegas)
        a = jax.device_put(jnp.asarray(alpha, jnp.float32), device)
        # warm-up / compile on a perturbed instance
        res = opt.solve(_perturb(om), a)
        np.asarray(res.us)
        times = []
        for eps in eps_list[:repeats]:
            om_i = _perturb(om, eps)
            t0 = time.perf_counter()
            r = opt.solve(om_i, a)
            np.asarray(r.us)
            times.append(time.perf_counter() - t0)
        times.sort()
        if want_result:
            res = opt.solve(om, a)
            np.asarray(res.us)
    return times[len(times) // 2], res


def _median_throughput(run, make_batch, B, repeats):
    """(B / median wall time, median wall time) of `run` on fresh batches."""
    np.asarray(run(make_batch()).us)  # compile + warm
    times = []
    for _ in range(repeats):
        batch = make_batch()
        t0 = time.perf_counter()
        np.asarray(run(batch).us)
        times.append(time.perf_counter() - t0)
    times.sort()
    t = times[len(times) // 2]
    return B / t, t


def _stack_perturbed(omegas, B):
    return jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[_perturb(omegas) for _ in range(B)])


def batched_throughput(opt, omegas, alpha, B, repeats):
    """Throughput of B independent solves vmapped in lockstep (the
    batched-problem axis, SURVEY.md 2.3 — the reference solves its
    30-repeat sweeps serially, drone_risk.py:498-503). Under vmap the
    while_loop runs to the max iteration count over the batch and lax.cond
    branches both execute; the reported number pays those costs."""
    a = jnp.asarray(alpha, jnp.float32)
    solve_b = jax.jit(jax.vmap(lambda om: opt.solve(om, a)))
    return _median_throughput(solve_b, lambda: _stack_perturbed(omegas, B),
                              B, repeats)


def scan_throughput(opt, omegas, alpha, B, repeats):
    """Aggregate throughput of B flagship-size instances through the
    on-device serial scheduler (`driver.solve_many`: one jitted `lax.scan`
    over instances, each at its own convergence schedule)."""
    alphas = jnp.full((B,), alpha, jnp.float32)
    return _median_throughput(lambda omb: opt.solve_many(omb, alphas),
                              lambda: _stack_perturbed(omegas, B), B, repeats)


def _golden(M, iters, alpha):
    path = os.path.join(GOLD_DIR, f"gold_drone_m{M}_a{alpha}_seed0_iters{iters}.npy")
    return np.load(path) if os.path.exists(path) else None


def _rel_l2(us, gold):
    us = np.asarray(us, np.float64)
    return float(np.linalg.norm(us - gold) / np.linalg.norm(gold))


def _mc(opt, us, mc_om, alpha, suffix=""):
    mc = opt.monte_carlo(us, mc_om, alpha)
    return {f"mc_{k}{suffix}": round(float(mc[v]), 4)
            for k, v in (("safe", "safe_frac"), ("avar", "avar"),
                         ("cost", "cost"))}


def hopper_bench(repeats):
    """Hopper NLP leg: the IPOPT-replacement engine (ops/nlp_ipm.py) in
    true f32 (kkt_ruiz_iters=3) — damped cold baseline, then warm-started
    SAA solves at the reference M=30 (hopper/hopper.py:44-56) and a scaled
    M, with out-of-sample MC safety (hopper/hopper.py:898-1008)."""
    from riskaversetrajopt_tpu.core.config import HopperScenario
    from riskaversetrajopt_tpu.experiments.hopper import no_slip_violation
    from riskaversetrajopt_tpu.models.hopper import HopperModel
    from riskaversetrajopt_tpu.ops.cvar import avar
    from riskaversetrajopt_tpu.ops.nlp_ipm import (
        NLPConfig,
        classify_rows,
        solve_nlp,
    )

    model = HopperModel(HopperScenario())
    out = {}

    def timed(fn, *args):
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn(*args))
        return time.perf_counter() - t0, r

    def perturb_params(params, eps):
        return jax.tree.map(lambda x: x * (1.0 + eps), params)

    def jitted(field, method, alpha, cfg):
        fp, gp, params, gL, gU, n_eq, xL, xU = model.make_nlp_params(
            field, method, alpha
        )
        row_perm = classify_rows(gL, gU, n_eq)
        return jax.jit(lambda Z, p: solve_nlp(
            fp, gp, gL, gU, n_eq, xL, xU, Z, cfg, params=p, row_perm=row_perm
        )), params

    # ---- damped cold baseline (f32 certifies the x64 basin: PARITY.md
    # round 4 — damp 50/0.1 + ruiz 3 -> jump 1.0535 in ~60 iters) ----
    solve_b, params_b = jitted(
        model.sample_friction(jax.random.PRNGKey(1), model.M, "baseline"),
        "baseline", 0.1,
        NLPConfig(tol=1e-4, max_iter=300, kkt_ruiz_iters=3, damp_iters=50,
                  damp_max=0.1),
    )
    Z0 = model.initial_guess(model.M, jnp.float32)
    solve_b(Z0, perturb_params(params_b, 3.1e-7))  # compile
    t_b, _ = timed(solve_b, Z0, perturb_params(params_b, 1.7e-7))
    res_b = solve_b(Z0, params_b)  # canonical, for the warm start
    xs_b, us_b, *_ = model.split_z(res_b.Z)
    out["baseline"] = {
        "seconds": round(t_b, 4),
        "iters": int(res_b.iters),
        "solved": bool(res_b.solved),
        "jump": round(float(xs_b[-1, 0]), 4),
    }

    alpha = 0.3
    s = model.scn
    mc_field = model.sample_friction(jax.random.PRNGKey(99), 10000, "saa")
    for M in (model.M, int(os.environ.get("BENCH_HOPPER_SCALED_M", "300"))):
        solve_s, params = jitted(
            model.sample_friction(jax.random.PRNGKey(2), M, "saa"), "saa",
            alpha, NLPConfig(tol=1e-3, max_iter=500, kkt_ruiz_iters=3),
        )
        n_xs = (s.S + 1) * s.n_x
        n_us = s.S * s.n_u
        Z0 = jnp.zeros(n_xs + n_us + M + 2, jnp.float32)
        Z0 = Z0.at[:n_xs].set(jnp.asarray(xs_b, jnp.float32).reshape(-1))
        Z0 = Z0.at[n_xs:n_xs + n_us].set(
            jnp.asarray(us_b, jnp.float32).reshape(-1)
        )
        solve_s(Z0, perturb_params(params, 4.2e-7))  # compile
        times = sorted(
            timed(solve_s, Z0, perturb_params(params, (2.0 + i) * 1e-7))[0]
            for i in range(repeats)
        )
        t_s = times[len(times) // 2]
        res_s = solve_s(Z0, params)  # canonical, for quality metrics
        xs_s, us_s, *_ = model.split_z(res_s.Z)
        mx = no_slip_violation(model, xs_s, us_s, mc_field)
        out[f"saa_M{M}"] = {
            "solves_per_s": round(1.0 / t_s, 4),
            "seconds": round(t_s, 4),
            "iters": int(res_s.iters),
            "solved": bool(res_s.solved),
            "jump": round(float(xs_s[-1, 0]), 4),
            "mc_safe": round(float(jnp.mean(mx <= 1e-6)), 4),
            "mc_avar": round(float(avar(mx, alpha)), 5),
            "alpha": alpha,
        }
    return out


def main():
    runtime.require_gpu()
    runtime.configure()
    dev = runtime.device_record()

    def emit(leg, **fields):
        print(json.dumps({"leg": leg, **dev, **fields}), flush=True)

    M = int(os.environ.get("BENCH_M", "1000"))
    iters = int(os.environ.get("BENCH_ITERS", "15"))
    repeats = int(os.environ.get("BENCH_REPEATS", "3"))
    backend = os.environ.get("BENCH_BACKEND", "admm")
    # Speed mode: warm-started structured ADMM + polish at eps (1e-4, 1e-4)
    # — every QP certified `solved` at a dual tolerance 10x TIGHTER than the
    # reference's own OSQP setting (OSQP_TOL=1e-3 gives eps_rel*||q||_inf
    # ~ 10; ours is 1.0).
    eps = float(os.environ.get("BENCH_EPS", "1e-4"))
    max_iter = int(os.environ.get("BENCH_MAX_ITER", "20000"))
    mc_M = int(os.environ.get("BENCH_MC_M", "10000"))
    # alpha=0.2 matches the committed golden fixture
    # (tests/fixtures/gold_drone_m1000_a0.2_seed0_iters15.npy)
    alpha = 0.2
    accel = jax.devices()[0]

    opt = make(iters, backend, eps, max_iter)
    omegas = opt.sample(jax.random.PRNGKey(0), M=M)
    gold = _golden(M, iters, alpha)
    # the reference's own oracle size (car/driving.py:621, drone_risk.py:647)
    mc_om = opt.sample(jax.random.PRNGKey(99), M=mc_M)

    # ---- speed (headline) ----
    import secrets

    eps_list = [
        (1.0 + secrets.randbelow(10**9) / 1e9) * 1e-7 for _ in range(repeats)
    ]
    t_accel, res = time_solve(opt, omegas, alpha, accel, repeats, eps_list)
    qp_iters = res.qp_iters.tolist()
    rec = {
        "metric": f"drone_risk SCP solves/s (M={M}, {iters} iters, 1 card, "
                  f"{backend})",
        "value": round(1.0 / t_accel, 4),
        "unit": "solves/s",
        "seconds": t_accel,
        "l2_final": float(res.l2_errors[-1]),
        "l2_vs_golden": None if gold is None else _rel_l2(res.us, gold),
        "qp_iters": qp_iters,
        "qp_solved": res.qp_solved.tolist(),
        "qp_capped": len([i for i in qp_iters if i >= max_iter]),
        **_mc(opt, res.us, mc_om, alpha),
    }
    if gold is not None:
        rec.update(_mc(opt, jnp.asarray(gold, jnp.float32), mc_om, alpha,
                       "_golden"))
    emit("speed", **rec)

    # ---- host CPU reference: same computation, same instances ----
    t_cpu, _ = time_solve(opt, omegas, alpha, jax.devices("cpu")[0], 1,
                          eps_list, want_result=False)
    emit("host_cpu", cpu_seconds=t_cpu, speed_seconds=t_accel,
         speed_vs_host_cpu=round(t_cpu / t_accel, 2))

    # ---- parity: the golden-branch certified configuration (base ADMM at
    # eps (1e-4, 1e-5) + compensated iterative-refinement rounds,
    # ops/qp_refine.py, for the QPs the raw f32 iteration stalls on) ----
    if int(os.environ.get("BENCH_PARITY", "1")) and gold is not None:
        from riskaversetrajopt_tpu.ops.qp_refine import IRConfig

        p_opt = make(
            iters, "admm-ir", 1e-4, 20000, eps_rel=1e-5,
            ir_cfg=IRConfig(
                base_eps_abs=1e-4, base_eps_rel=1e-5, base_max_iter=20000
            ),
            polish=False, rho_ws=False,
        )
        t_par, res_par = time_solve(p_opt, omegas, alpha, accel, 3)
        emit("parity",
             solves_per_s=round(1.0 / t_par, 4),
             seconds=t_par,
             l2_vs_golden=_rel_l2(res_par.us, gold),
             # qp_iters include base + refinement-round iterations, so
             # certification is read from qp_solved, not from a cap test
             qp_uncertified=len([v for v in res_par.qp_solved.tolist()
                                 if not v]),
             **_mc(p_opt, res_par.us, mc_om, alpha))

    # ---- batched: the reference's sweep shape (30 repeats x M=50,
    # drone_risk.py:55-56,498-503) in lockstep, and the flagship size
    # through solve_many ----
    B = int(os.environ.get("BENCH_BATCH", "30"))
    if B > 1:
        Mb = int(os.environ.get("BENCH_BATCH_M", "50"))
        om_b = opt.sample(jax.random.PRNGKey(0), M=Mb)
        r = max(1, repeats - 1)
        bsps, t_b = batched_throughput(opt, om_b, alpha, B, r)
        t_1, _ = time_solve(opt, om_b, alpha, accel, r, want_result=False)
        out = {
            "batch": B, "M": Mb,
            "solves_per_s": round(bsps, 4),
            "batch_seconds": t_b,
            "serial_solve_s": t_1,
            "speedup_vs_serial": round(bsps * t_1, 2),
        }
        Bs = int(os.environ.get("BENCH_SCAN_B", "4"))
        if Bs > 1:
            ssps, t_s = scan_throughput(opt, omegas, alpha, Bs, r)
            out["scan_flagship"] = {
                "batch": Bs, "M": M,
                "solves_per_s": round(ssps, 4),
                "batch_seconds": t_s,
                "serial_solve_s": t_accel,
                "speedup_vs_serial": round(ssps * t_accel, 2),
            }
        emit("batched", **out)

    # ---- ds: double-single ADMM iterates (ops/admm_ds.py), every QP at
    # eps 1e-6 ----
    if int(os.environ.get("BENCH_DS", "1")) and M == 1000:
        ds_opt = make(iters, "admm-ds", 1e-6, 45000, eps_rel=1e-6,
                      polish=False, rho_ws=False, kkt_inv=False)
        t_ds, res_ds = time_solve(ds_opt, omegas, alpha, accel, 1)
        emit("ds",
             solves_per_s=round(1.0 / t_ds, 4),
             seconds=t_ds,
             qp_iters=res_ds.qp_iters.tolist(),
             qp_uncertified=len([v for v in res_ds.qp_solved.tolist()
                                 if not v]),
             l2_vs_golden=None if gold is None else _rel_l2(res_ds.us, gold),
             **_mc(ds_opt, res_ds.us, mc_om, alpha))

    if int(os.environ.get("BENCH_HOPPER", "1")):
        emit("hopper", **hopper_bench(max(1, repeats - 1)))


if __name__ == "__main__":
    main()
