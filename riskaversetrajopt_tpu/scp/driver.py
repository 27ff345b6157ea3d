"""SCP driver: the full sequential-convex-programming loop as one XLA program.

The reference's SCP loop (car/driving.py:467-530, drone/drone_risk.py:495-540)
alternates a jitted JAX "define" phase with a host-side OSQP "solve" phase,
crossing the Python<->C boundary twice per iteration and shipping a dense
(M*K+...) x (n+M+2) matrix through scipy.sparse each time. Here one SCP
iteration = linearize (scan+vmap rollout) + pack (structured epigraph) +
IPM/ADMM solve, all inside a single `lax.scan` over iterations — zero host
round-trips for the entire solve, warm-startable, and vmappable over
independent problem instances (the (alpha x repeat) sweep axis,
SURVEY.md section 2.3 "batched-problem parallelism").

Iteration gating reproduces the reference exactly (car/driving.py:411-415,
drone/drone_risk.py:413-417) via the structured operator's gate masks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from riskaversetrajopt_tpu.core.config import SCPConfig, SolverConfig
from riskaversetrajopt_tpu.ops import admm
from riskaversetrajopt_tpu.ops.cvar import avar
from riskaversetrajopt_tpu.ops.ipm import IPMConfig, solve_qp_ipm
from riskaversetrajopt_tpu.ops.rollout import linearize_batch, rollout_batch
from riskaversetrajopt_tpu.ops.saa_qp import (
    SAAQPData,
    SAAQPOps,
    SAAQPStatic,
    build_bounds,
    build_objective,
    pack_saa_qp_data,
    solve_saa_qp,
)


# backends whose QPSolution.rho is meaningful (ADMM family); the others carry
# the previous rho forward untouched
RHO_BACKENDS = ("admm", "admm-ds")


class SCPResult(NamedTuple):
    us: jnp.ndarray  # (S, n_u) final controls
    xs: jnp.ndarray  # (M, S+1, n_x) trajectories under the final controls
    t_risk: jnp.ndarray  # CVaR epigraph t at the last iteration
    l2_errors: jnp.ndarray  # (num_iters,) relative control-update errors
    qp_iters: jnp.ndarray  # (num_iters,) solver iterations per SCP step
    qp_solved: jnp.ndarray  # (num_iters,) solver convergence flags
    us_history: jnp.ndarray  # (num_iters, S, n_u)


def l2_error_us(us_mat, us_mat_prev):
    """Relative L2 control-update error (car/driving.py:459-464)."""
    err = jnp.mean(jnp.linalg.norm(us_mat - us_mat_prev, axis=-1))
    return err / jnp.mean(jnp.linalg.norm(us_mat, axis=-1))


class SAATrajOpt:
    """User-facing facade bundling a model with solver/SCP configuration.

    Typical use:
        opt = SAATrajOpt(DroneModel(), method='saa')
        omegas = opt.sample(jax.random.PRNGKey(0), M=1000)
        res = opt.solve(omegas, alpha=0.1)           # jitted end-to-end
    """

    def __init__(
        self,
        model,
        method: str = "saa",
        scp_cfg: Optional[SCPConfig] = None,
        # ADMM with warm start is the default: it reproduces the reference's
        # OSQP-in-the-loop semantics, and the warm start acts as an implicit
        # proximal stabilizer of the (trust-region-free) SCP iteration — the
        # IPM backend solves each QP more accurately but jumps to the analytic
        # center of degenerate optimal faces, which can make the naive SCP
        # fixed-point iteration oscillate.
        qp_backend: str = "admm",
        ipm_cfg: Optional[IPMConfig] = None,
        admm_cfg: Optional[SolverConfig] = None,
        # refinement knobs for the 'admm-ir' backend (ops/qp_refine.IRConfig)
        ir_cfg=None,
        # 'hybrid-prox' backend knobs
        hybrid_cap: int = 3000,
        hybrid_prox: float = 1e-3,
        slack_penalty: Optional[float] = None,
        baseline_pad: float = 0.0,
        dtype=jnp.float64,
        # (Mesh, axis_name): pin every (M, ...)-leading operator
        # intermediate to this sample axis with explicit sharding
        # constraints instead of relying on GSPMD's cost model (see
        # SAAQPStatic.sample_pin). Numerics are identical.
        sample_pin=None,
    ):
        self.model = model
        self.method = method
        self.qp_backend = qp_backend
        # tol 1e-5 (relative merit) is ~100x tighter than the reference's
        # OSQP_TOL and reliably attainable on the degenerate epigraph QPs
        self.ipm_cfg = ipm_cfg or IPMConfig(tol=1e-5, max_iter=40)
        # eps 1e-6: measured against reference-semantics golden trajectories
        # (tests/test_reference_parity.py), the SCP endpoint error tracks the
        # QP tolerance with ~1000x amplification through the post-gating
        # transition iterations: eps 1e-5 left a 1.9e-2 trajectory error at
        # M=50 while 1e-6 achieves 2.2e-4 — inside the 1e-3 north star.
        # polish=False inside the SCP loop: the post-gating QPs have
        # degenerate optimal faces, and an accepted polish snaps the iterate
        # to an exact active-set vertex. Which QPs polish succeeds on is a
        # solver-specific accident (the reference's OSQP accepts on a
        # different subset than any reimplementation can reproduce), so
        # polishing inside the loop *perturbs* golden-trajectory tracking
        # instead of helping it: at M=50/eps=1e-6, polish=False tracks the
        # tightened reference golden at 2.2e-4 while polish=True lands at
        # 1.6e-3. The eps=1e-6 termination already exceeds the accuracy the
        # reference gets from OSQP_TOL=1e-3 + polish. Standalone QP solves
        # keep SolverConfig's polish=True default (OSQP parity).
        # kkt_refine_iters=1: each in-loop refinement pass costs 2 extra
        # G-sweeps per ADMM iteration, but the refined KKT solves make
        # consecutive warm-started solutions consistent, so the whole SCP
        # needs ~4x fewer ADMM iterations (M=1000 f32, eps 1e-4 + polish:
        # 5725 total iterations, l2_final 5.7e-3, with refine=1 vs 22450 and
        # 1.4e-1 with refine=0; PARITY.md round 3).
        # max_iter=50000: at M=1000 (seed 0, alpha 0.2) the post-gating
        # transition QP certifies at eps 1e-6 after 33,500 f64 iterations; a
        # 20000 cap left it uncertified (l2 vs golden 1.7e-4 capped, 1.9e-4
        # certified; chip_smoke.py drone_f64).
        self.admm_cfg = admm_cfg or SolverConfig(
            eps_abs=1e-6, eps_rel=1e-6, max_iter=50000,
            polish=False, kkt_refine_iters=1,
        )
        if ir_cfg is None:
            from riskaversetrajopt_tpu.ops.qp_refine import IRConfig

            ir_cfg = IRConfig()
        self.ir_cfg = ir_cfg
        if (
            getattr(self.admm_cfg, "eps_sched_iters", 0) > 0
            and qp_backend != "admm"
        ):
            # the inexact-SCP schedule threads a traced eps multiplier into
            # ops/admm.admm_solve; the other backends run their own
            # termination and would silently ignore it — fail loudly
            raise ValueError(
                "SolverConfig.eps_sched_iters is only implemented for the "
                f"'admm' backend (got {qp_backend!r})"
            )
        # 'hybrid-prox' backend knobs: per-leg ADMM iteration bound and the
        # proximal weight of the branch-preserving rescue IPM
        self.hybrid_cap = hybrid_cap
        self.hybrid_prox = hybrid_prox
        self.dtype = dtype
        scn = model.scn
        n = model.S * model.n_u
        if scp_cfg is None:
            scp_cfg = model.default_scp_config()
        self.scp_cfg = scp_cfg
        # objective diagonal: 2*dt*R per step (car/driving.py:375-389)
        self.p_diag_u = jnp.tile(2.0 * model.dt * jnp.diag(scn.R), model.S).astype(
            dtype
        )
        self.static = SAAQPStatic(
            n=n,
            M=-1,  # filled in per-solve (depends on the sample count)
            K=model.K,
            n_fc=model.n_fc,
            n_x=model.n_x,
            row_scale=model.row_scale,
            slack_penalty=(
                slack_penalty
                if slack_penalty is not None
                else model.slack_penalty
            ),
            u_max=float(scn.u_max),
            baseline=(method == "baseline"),
            baseline_pad=baseline_pad,
            gate_iters=scp_cfg.gate_iters,
            gate_scale=scp_cfg.gate_row_scale,
            gate_l=scp_cfg.gate_bound_l,
            gate_u=scp_cfg.gate_bound_u,
            sample_pin=sample_pin,
        )

    # -- sampling ----------------------------------------------------------
    def sample(self, key, M: int, method: Optional[str] = None):
        return self.model.sample(key, M, method or self.method)

    # -- one SCP iteration (define + solve) --------------------------------
    def _static_for(self, M: int) -> SAAQPStatic:
        return self.static._replace(M=M)

    def _define(self, us_prev, omegas, alpha, M, model=None, p_diag_u=None):
        # `model`/`p_diag_u` are the ARGUMENT-ROOTED variants passed through
        # the jit boundary by solve()/solve_instrumented() (models/base
        # ConstBind: array constants travel as jit arguments instead of
        # being baked into the rollout scan).
        model = self.model if model is None else model
        p_diag_u = self.p_diag_u if p_diag_u is None else p_diag_u
        us_prev_vec = us_prev.reshape(-1)
        lin = linearize_batch(model, us_prev, omegas)
        return pack_saa_qp_data(lin, us_prev_vec, p_diag_u, alpha)

    def _warm_rho(self, warm, scp_iter):
        """warm[2]: the previous QP's adapted rho — OSQP keeps rho in its
        workspace across the reference's setup-once-then-update SCP loop
        (drone_risk.py:443-452), so each solve resumes from it instead of
        re-adapting from cfg.rho. EXCEPT at the gating transition
        (scp_iter == gate_iters): the subproblem changes structurally there
        (the 1e-7-scaled obstacle rows come live, drone_risk.py:413-417) and
        inheriting the gated QPs' rho triples the transition QP's iteration
        count (measured 12550 vs 3425 at M=1000); restart from cfg.rho."""
        if warm is None or len(warm) <= 2 or not getattr(
            self.admm_cfg, "rho_warm_start", True
        ):
            return None
        return jnp.where(
            jnp.asarray(scp_iter) == self.scp_cfg.gate_iters,
            jnp.asarray(self.admm_cfg.rho, self.dtype),
            warm[2],
        )

    def _solve_qp(self, st, data, scp_iter, warm=None):
        def ipm_solve():
            ops = SAAQPOps(st, data, scp_iter)
            _, q = build_objective(st, data)
            l, u = build_bounds(st, data, scp_iter)
            return solve_qp_ipm(ops, q, l, u, n_eq=st.n_fc, cfg=self.ipm_cfg)

        def admm_solve():
            x0 = warm[0] if warm is not None else None
            y0 = warm[1] if warm is not None else None
            rho0 = self._warm_rho(warm, scp_iter)
            eps_scale = None
            if getattr(self.admm_cfg, "eps_sched_iters", 0) > 0:
                # inexact-SCP tolerance schedule (SolverConfig
                # .eps_sched_iters): early subproblems terminate at
                # factor * eps — they only seed the next linearization
                eps_scale = jnp.where(
                    jnp.asarray(scp_iter) < self.admm_cfg.eps_sched_iters,
                    jnp.asarray(self.admm_cfg.eps_sched_factor, self.dtype),
                    jnp.asarray(1.0, self.dtype),
                )
            return solve_saa_qp(st, data, scp_iter, self.admm_cfg, x0=x0,
                                y0=y0, rho0=rho0, eps_scale=eps_scale)

        if self.qp_backend == "ipm":
            return ipm_solve()
        elif self.qp_backend == "admm":
            return admm_solve()
        elif self.qp_backend == "admm-ir":
            # f32-native tight tolerances: plain f32 ADMM stalls near
            # unscaled residuals ~1e-5 at M=1000 (13/15 QPs cap at eps
            # 1e-6; PARITY.md round 4), while golden tracking needs 1e-6.
            # QP-level iterative refinement (ops/qp_refine.py) runs the
            # f32 ADMM at its reliable working tolerance and contracts the
            # compensated true residuals by ~1/Delta per correction round.
            from riskaversetrajopt_tpu.ops.qp_refine import solve_saa_qp_ir

            x0 = warm[0] if warm is not None else None
            y0 = warm[1] if warm is not None else None
            return solve_saa_qp_ir(
                st, data, scp_iter, self.admm_cfg, ir=self.ir_cfg,
                x0=x0, y0=y0,
            )
        elif self.qp_backend == "admm-ds":
            # Double-single (compensated f32) ADMM iterates — the on-chip
            # high-precision leg that tracks the reference's x64 solution
            # branch through the degenerate post-gating QPs (the f32 path's
            # ~6e-8/iter noise selects a different optimal-face point; see
            # ops/admm_ds.py). Use with the driver's golden-parity config
            # (eps 1e-6, polish=False, rho_warm_start=False).
            from riskaversetrajopt_tpu.ops.admm_ds import solve_saa_qp_ds

            x0 = warm[0] if warm is not None else None
            y0 = warm[1] if warm is not None else None
            rho0 = self._warm_rho(warm, scp_iter)
            return solve_saa_qp_ds(
                st, data, scp_iter, self.admm_cfg, x0=x0, y0=y0, rho0=rho0,
                ds_kkt_passes=getattr(self.admm_cfg, "ds_kkt_passes", 1),
            )
        elif self.qp_backend == "hybrid-prox":
            # demoted out of the public backend set: at the flagship size
            # (M=1000/f32) the proximal rescue lands off the warm iterate's
            # face (2/15 QPs certified, MC cost 22 vs 0.48) — the certified
            # tight-tolerance configuration is 'admm-ir'
            raise ValueError(
                "'hybrid-prox' is experimental and fails at M=1000/f32; "
                "use qp_backend='admm-ir' for certified tight tolerances, "
                "or opt into the experimental backend as '_hybrid-prox'"
            )
        elif self.qp_backend == "_hybrid-prox":
            # Golden-branch rescue for the post-gating transition QPs.
            # Warm-started ADMM follows the reference's OSQP solution branch
            # but needs >20k f32 iterations to push the dual residual
            # through 1e-2 on the transition QPs (the reference's own
            # x64 engine needs ~22k there). Instead: a bounded ADMM leg
            # keeps the warm path; if it does not certify, a PROXIMAL
            # interior-point solve (P + sigma I, q - sigma*x_admm) centered
            # at the ADMM iterate computes (approximately) the projection
            # of that iterate onto the optimal face in ~30 matmul-heavy
            # iterations — preserving the branch that plain IPM loses on
            # degenerate faces — and a short warm ADMM leg certifies the
            # result at the target tolerance.
            # STATUS: validated at small M (tests); at M=1000/f32 the
            # prox-IPM itself fails to land near the warm iterate's face
            # (measured: 2/15 certified, MC cost 22 vs 0.48) — use the
            # 'admm-ir' base-at-target + refinement-rescue configuration
            # there (bench.py parity mode).
            import dataclasses

            from riskaversetrajopt_tpu.ops.qp_refine import _ProxOps

            quick_cfg = dataclasses.replace(
                self.admm_cfg, max_iter=self.hybrid_cap, polish=False
            )
            fin_cfg = dataclasses.replace(
                self.admm_cfg, max_iter=self.hybrid_cap
            )
            x0 = warm[0] if warm is not None else None
            y0 = warm[1] if warm is not None else None
            s1 = solve_saa_qp(st, data, scp_iter, quick_cfg, x0=x0, y0=y0)

            def rescue():
                ops = SAAQPOps(
                    st, data, scp_iter,
                    kkt_refine_iters=self.admm_cfg.kkt_refine_iters,
                )
                _, q = build_objective(st, data)
                l, u = build_bounds(st, data, scp_iter)
                sig = jnp.asarray(self.hybrid_prox, self.dtype)
                si = solve_qp_ipm(
                    _ProxOps(ops, sig), q - sig * s1.x, l, u,
                    n_eq=st.n_fc, cfg=self.ipm_cfg,
                )
                s2 = solve_saa_qp(
                    st, data, scp_iter, fin_cfg, x0=si.x, y0=si.y
                )
                return s2._replace(iters=s1.iters + si.iters + s2.iters)

            def keep():
                # re-apply polish semantics to the certified quick leg
                return s1

            return jax.lax.cond(s1.solved, keep, rescue)
        elif self.qp_backend == "hybrid":
            # The first post-gating subproblems involve a large active-set
            # shift (the linearized obstacle rows switch on all at once,
            # drone_risk.py:413-417) and take thousands of warm-startless ADMM
            # iterations; Mehrotra gets into the solution's basin in ~20-40
            # heavy matmul-friendly iterations. The handoff is WITHIN the QP:
            # ADMM warm-started from the IPM point finishes to the certified
            # unscaled tolerance (and keeps the prox-to-previous-iterate
            # behavior that stabilizes the trust-region-free SCP recursion —
            # returning raw IPM solutions to SCP makes the outer loop
            # oscillate and was observed to diverge at M=1000/f32).
            # The tail subproblems barely change between SCP iterations and
            # warm-started ADMM alone converges in ~25 iterations.
            def ipm_then_admm():
                si = ipm_solve()
                return solve_saa_qp(
                    st, data, scp_iter, self.admm_cfg, x0=si.x, y0=si.y
                )

            switch = self.scp_cfg.gate_iters + 3
            return jax.lax.cond(scp_iter < switch, ipm_then_admm, admm_solve)
        raise ValueError(f"unknown qp backend {self.qp_backend}")

    # -- full SCP solve ----------------------------------------------------
    def solve(
        self,
        omegas,
        alpha,
        M: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 1,
    ) -> SCPResult:
        """Run the full SCP loop (fixed iteration count, reference semantics:
        convergence is monitored but not used for termination,
        car/driving.py:500-513).

        Thin wrapper gathering the model's array constants into jit
        ARGUMENTS (models/base.ConstBind) — vmap/jit-compatible.

        `checkpoint_path` enables mid-solve checkpoint/resume on this FUSED
        path (SURVEY §5; `solve_instrumented` has the Python-loop variant):
        every `checkpoint_every`-th SCP iteration an ordered
        `io_callback` snapshots (iteration, us, ADMM warm starts, adapted
        rho) to the file, and a fresh `solve` call with the same path
        resumes the `lax.scan` at the recorded iteration with the saved
        carry. The resumed result's per-iteration arrays (l2_errors,
        qp_iters, ...) cover only the remaining iterations."""
        if M is None:
            M = jax.tree.leaves(omegas)[0].shape[0]
        consts = {"model": self.model.consts(), "p_diag_u": self.p_diag_u}
        if checkpoint_path is None:
            return self._solve_jit(omegas, alpha, consts, M)
        from riskaversetrajopt_tpu.utils import checkpoint as ckpt

        saved = ckpt.load(checkpoint_path)
        start_iter = 0
        resume = None
        if saved is not None:
            start_iter = saved.scp_iter
            resume = (
                jnp.asarray(saved.us, self.dtype),
                (
                    jnp.asarray(saved.warm_x, self.dtype),
                    jnp.asarray(saved.warm_y, self.dtype),
                    jnp.asarray(
                        self.admm_cfg.rho
                        if saved.warm_rho is None
                        else saved.warm_rho,
                        self.dtype,
                    ),
                ),
            )
        return self._solve_ckpt_jit(
            omegas, alpha, consts, M, start_iter,
            str(checkpoint_path), int(checkpoint_every), resume,
        )

    # -- many independent instances: on-device serial scheduler -------------
    def solve_many(self, omegas, alphas, M: Optional[int] = None) -> SCPResult:
        """Solve B independent problem instances inside ONE jitted program:
        `lax.scan` over the leading instance axis (the reference's alpha x
        repeat sweep axis, drone_risk.py:498-503, solved serially there).

        This is the large-M batched-problem scheduler. Lockstep `vmap`
        batching pays off where per-solve latency dominates (small M), but
        it makes every instance pay the max iteration count over the batch,
        and at M=1000 each iteration already streams the whole G stack
        several times. Scanning instead runs each
        instance at its OWN convergence schedule with zero per-instance
        dispatch/host round-trips, matching serial aggregate throughput
        while keeping the whole sweep a single XLA program.

        `omegas` leaves carry a leading (B, ...) axis; `alphas` is (B,)
        (per-instance risk levels — one compile covers the whole sweep).
        Returns an SCPResult with a leading (B, ...) axis on every field."""
        if M is None:
            M = jax.tree.leaves(omegas)[0].shape[1]
        alphas = jnp.asarray(alphas, self.dtype)
        consts = {"model": self.model.consts(), "p_diag_u": self.p_diag_u}
        return self._solve_many_jit(omegas, alphas, consts, M)

    @functools.partial(jax.jit, static_argnums=(0, 4))
    def _solve_many_jit(self, omegas, alphas, consts, M: int) -> SCPResult:
        def body(_, inp):
            om_i, a_i = inp
            return 0, self._solve_core(om_i, a_i, consts, M)

        _, results = jax.lax.scan(body, 0, (omegas, alphas))
        return results

    @functools.partial(jax.jit, static_argnums=(0, 4))
    def _solve_jit(self, omegas, alpha, consts, M: int) -> SCPResult:
        return self._solve_core(omegas, alpha, consts, M)

    @functools.partial(jax.jit, static_argnums=(0, 4, 5, 6, 7))
    def _solve_ckpt_jit(
        self, omegas, alpha, consts, M, start_iter, ckpt_path, ckpt_every,
        resume,
    ) -> SCPResult:
        return self._solve_core(
            omegas, alpha, consts, M, start_iter=start_iter,
            ckpt=(ckpt_path, ckpt_every), resume=resume,
        )

    def _solve_core(
        self, omegas, alpha, consts, M: int, start_iter: int = 0,
        ckpt=None, resume=None,
    ) -> SCPResult:
        omegas = jax.tree.map(lambda x: jnp.asarray(x, self.dtype), omegas)
        st = self._static_for(M)
        model = self.model.bind(
            jax.tree.map(lambda a: jnp.asarray(a, self.dtype),
                         consts["model"])
        )
        p_diag_u = jnp.asarray(consts["p_diag_u"], self.dtype)
        n = st.n
        us0 = model.initial_guess().astype(self.dtype)
        nv = n + M + 2
        warm0 = (
            jnp.zeros(nv, self.dtype),
            jnp.zeros(st_total_rows(st), self.dtype),
            jnp.asarray(self.admm_cfg.rho, self.dtype),
        )
        if resume is not None:
            us0, warm0 = resume
        def step(carry, scp_iter):
            us_prev, warm = carry
            data = self._define(
                us_prev, omegas, alpha, M, model=model, p_diag_u=p_diag_u
            )
            sol = self._solve_qp(st, data, scp_iter, warm)
            rho_next = (
                sol.rho.astype(self.dtype)
                if self.qp_backend in RHO_BACKENDS
                else warm[2]
            )
            us = sol.x[:n].reshape(model.S, model.n_u)
            l2 = l2_error_us(us, us_prev)
            if ckpt is not None:
                # ordered host snapshot of the scan carry (SURVEY §5
                # checkpoint/resume on the fused path); the host callback
                # drops off-cadence iterations, so the device pays one
                # small D2H per SCP iteration, not per-file-write
                path, every = ckpt
                num_iters = self.scp_cfg.num_iters

                def _snap(it, us_v, wx, wy, rho_v):
                    it = int(it)
                    if it % int(every) == 0 or it == num_iters:
                        from riskaversetrajopt_tpu.utils import (
                            checkpoint as _ckpt,
                        )

                        _ckpt.save(path, it, us_v, wx, wy, rho_v)

                from jax.experimental import io_callback

                io_callback(
                    _snap, None, scp_iter + 1, us, sol.x, sol.y, rho_next,
                    ordered=True,
                )
            return (us, (sol.x, sol.y, rho_next)), (
                l2,
                sol.x[-1],
                sol.iters,
                sol.solved,
                us,
            )

        (us, _), (l2s, t_risks, qp_iters, qp_solved, us_hist) = jax.lax.scan(
            step, (us0, warm0),
            jnp.arange(start_iter, self.scp_cfg.num_iters),
        )
        xs = rollout_batch(model, us, omegas)
        return SCPResult(
            us=us,
            xs=xs,
            t_risk=t_risks[-1],
            l2_errors=l2s,
            qp_iters=qp_iters,
            qp_solved=qp_solved,
            us_history=us_hist,
        )

    # -- instrumented solve: define/solve timing split ----------------------
    def solve_instrumented(
        self,
        omegas,
        alpha,
        M: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
    ):
        """Python-driven SCP loop with separately jitted define and solve
        phases, reproducing the reference's timing harness semantics
        (car/driving.py:482-513: per-iteration define time, solve time,
        cumulative time, L2 error). The fused `solve` is the production path;
        this one exists for reference-comparable profiling (the
        define/solve split IS the reference's profiling model,
        SURVEY.md section 5)."""
        import time as _time

        if M is None:
            M = jax.tree.leaves(omegas)[0].shape[0]
        st = self._static_for(M)
        model = self.model
        n = st.n

        # model constants as jit arguments (models/base.ConstBind)
        mconsts = self.model.consts()
        define_fn = jax.jit(
            lambda us_prev, om, a, mc, pdu: self._define(
                us_prev, om, a, M, model=self.model.bind(mc), p_diag_u=pdu
            )
        )
        _define_fn = define_fn
        define_fn = lambda us_prev, om, a: _define_fn(  # noqa: E731
            us_prev, om, a, mconsts, self.p_diag_u
        )
        solve_fn = jax.jit(
            lambda data, it, warm: self._solve_qp(st, data, it, warm)
        )

        nv = n + M + 2
        warm = (
            jnp.zeros(nv, self.dtype),
            jnp.zeros(st_total_rows(st), self.dtype),
            jnp.asarray(self.admm_cfg.rho, self.dtype),
        )
        us_prev = model.initial_guess().astype(self.dtype)
        alpha = jnp.asarray(alpha, self.dtype)

        # warm-up compile pass (reference: car/driving.py:474-480)
        jax.block_until_ready(define_fn(us_prev, omegas, alpha))
        d0 = define_fn(us_prev, omegas, alpha)
        jax.block_until_ready(solve_fn(d0, jnp.asarray(0), warm))

        # mid-solve checkpoint/resume (SURVEY.md section 5): resume at the
        # recorded iteration with the saved iterate and ADMM warm starts
        start_iter = 0
        if checkpoint_path is not None:
            from riskaversetrajopt_tpu.utils import checkpoint as ckpt

            saved = ckpt.load(checkpoint_path)
            if saved is not None:
                start_iter = saved.scp_iter
                us_prev = jnp.asarray(saved.us, self.dtype)
                warm = (
                    jnp.asarray(saved.warm_x, self.dtype),
                    jnp.asarray(saved.warm_y, self.dtype),
                    jnp.asarray(
                        self.admm_cfg.rho
                        if saved.warm_rho is None else saved.warm_rho,
                        self.dtype,
                    ),
                )

        define_times, solve_times, cum_times, l2s = [], [], [], []
        total = 0.0
        for it in range(start_iter, self.scp_cfg.num_iters):
            t0 = _time.perf_counter()
            data = jax.block_until_ready(define_fn(us_prev, omegas, alpha))
            t_def = _time.perf_counter() - t0
            t0 = _time.perf_counter()
            sol = jax.block_until_ready(solve_fn(data, jnp.asarray(it), warm))
            t_sol = _time.perf_counter() - t0
            us = sol.x[:n].reshape(model.S, model.n_u)
            l2s.append(float(l2_error_us(us, us_prev)))
            us_prev = us
            warm = (
                sol.x, sol.y,
                sol.rho.astype(self.dtype)
                if self.qp_backend in RHO_BACKENDS
                else warm[2],
            )
            total += t_def + t_sol
            define_times.append(t_def)
            solve_times.append(t_sol)
            cum_times.append(total)
            if checkpoint_path is not None:
                from riskaversetrajopt_tpu.utils import checkpoint as ckpt

                ckpt.save(checkpoint_path, it + 1, us_prev, warm[0], warm[1],
                          warm_rho=np.asarray(warm[2]))
        xs = rollout_batch(model, us_prev, omegas)
        return {
            "us": us_prev,
            "xs": xs,
            "define_times": np.array(define_times),
            "solve_times": np.array(solve_times),
            "cum_times": np.array(cum_times),
            "l2_errors": np.array(l2s),
        }

    # -- Monte-Carlo validation oracle -------------------------------------
    def monte_carlo(self, us, omegas, alpha, tol: Optional[float] = None):
        """Out-of-sample validation: per-sample max constraint <= tol + 1e-6
        => safe; returns safe fraction, AVaR of the max-constraint statistic,
        and the control cost.

        Statistic semantics per workload (verified against the reference):
        car AND drone_risk feed `max(g) - OSQP_TOL` to both the safety test
        and AVaR (car/driving.py:636 `np.max(val_obs) - OSQP_TOL`,
        drone/drone_risk.py:660 `jnp.max(ineqs) - OSQP_TOL`), which this
        method reproduces with the default tol. drone_main_plot and hopper
        use the RAW max (drone_main_plot.py:637-639 with safe threshold
        OSQP_TOL + 1e-6; hopper/hopper.py:923-924 with threshold 1e-6) —
        those experiment harnesses compute their statistics directly and do
        not route through this method (pass tol=0.0 to match them here)."""
        # pin everything to the facade dtype: callers mix loaded .npy
        # controls, fresh samples and model constants, which under a
        # CPU-x64 session would silently promote an f32 solve's MC oracle
        # to f64 (and break the rollout scan's carry typing)
        model = self.model.bind(
            jax.tree.map(
                lambda a: jnp.asarray(a, self.dtype), self.model.consts()
            )
        )
        us = jnp.asarray(us, self.dtype)
        omegas = jax.tree.map(
            lambda x: jnp.asarray(x, self.dtype), omegas
        )
        tol = model.scn.osqp_tol if tol is None else tol

        def one(om):
            from riskaversetrajopt_tpu.ops.rollout import rollout

            xs = rollout(model, us, om)
            g = model.ineq_constraints(xs, om)
            return jnp.max(g) - tol

        max_cons = jax.vmap(one)(omegas)
        safe = jnp.mean((max_cons <= 1e-6).astype(self.dtype))
        avar_val = avar(max_cons, alpha)
        cost = model.control_cost(us)
        return {"safe_frac": safe, "avar": avar_val, "cost": cost,
                "max_constraints": max_cons}


def st_total_rows(st: SAAQPStatic) -> int:
    return st.n_fc + 1 + st.M + st.M * st.K + 1 + st.n
