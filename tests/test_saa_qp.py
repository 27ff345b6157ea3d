"""Structured SAA QP vs an independent dense NumPy construction of the
reference packing (car/driving.py:301-373, drone/drone_risk.py:282-374):
matvec equivalence, Schur-complement KKT solve correctness, and full ADMM
solution equality between the structured and dense paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riskaversetrajopt_tpu.core.config import DroneScenario, SolverConfig
from riskaversetrajopt_tpu.models.drone import DroneModel
from riskaversetrajopt_tpu.ops import admm
from riskaversetrajopt_tpu.ops.rollout import linearize_batch
from riskaversetrajopt_tpu.ops.saa_qp import (
    SAAQPData,
    SAAQPOps,
    SAAQPStatic,
    build_bounds,
    build_objective,
    pack_saa_qp_data,
    solve_saa_qp,
)


def dense_reference_A(st, data, scp_iter):
    """Independent dense transcription of the reference row layout
    [final | cvar | y | sample blocks | slack | control] over variables
    [u | y | s | t], with MULTIPLIER and gating semantics."""
    n, M, K, m = st.n, st.M, st.K, st.row_scale
    nv = n + M + 2
    F = np.asarray(data.F)
    G = np.asarray(data.G)
    g_up = np.asarray(data.g_up)
    Malpha = M * float(data.alpha)

    rows = []
    ls, us = [], []
    # final
    for r in range(st.n_fc):
        row = np.zeros(nv)
        row[:n] = F[r]
        rows.append(row)
        ls.append(float(data.f_rhs[r]))
        us.append(float(data.f_rhs[r]))
    # cvar row — the reference sets columns n_u*S through -2 INCLUSIVE
    # (`.at[0, (n_u*S):-1].set(1.0)`, car/driving.py:341-342), which covers
    # the slack column: sum(y) + s + M*alpha*t <= 0
    row = np.zeros(nv)
    if not st.baseline:
        row[n:-1] = 1.0
        row[-1] = Malpha
    rows.append(row)
    ls.append(-np.inf)
    us.append(0.0)
    # y rows
    for i in range(M):
        row = np.zeros(nv)
        if not st.baseline:
            row[n + i] = -1.0
            row[-2] = -1.0
        rows.append(row)
        ls.append(-np.inf)
        us.append(0.0)
    # sample rows
    for i in range(M):
        for k in range(K):
            row = np.zeros(nv)
            row[:n] = m * G[i, k]
            if not st.baseline:
                row[n + i] = -m
                row[-1] = -m
            rows.append(row)
            ls.append(-np.inf)
            us.append(
                m * (g_up[i, k] - (st.baseline_pad if st.baseline else 0.0))
            )
    # slack row
    row = np.zeros(nv)
    if not st.baseline:
        row[-2] = -1.0
    rows.append(row)
    ls.append(-np.inf)
    us.append(0.0)

    A = np.array(rows)
    l = np.array(ls)
    u = np.array(us)

    # gating: rows >= n_x scaled/clamped (drone semantics)
    if scp_iter < st.gate_iters:
        A[st.n_x :] *= st.gate_scale
        l[st.n_x :] = st.gate_l
        u[st.n_x :] = st.gate_u

    # control rows appended after (never gated)
    A_ctrl = np.zeros((n, nv))
    A_ctrl[:, :n] = np.eye(n)
    A = np.vstack([A, A_ctrl])
    l = np.concatenate([l, -st.u_max * np.ones(n)])
    u = np.concatenate([u, st.u_max * np.ones(n)])
    return A, l, u


def make_problem(M=6, baseline=False, alpha=0.1):
    scn = DroneScenario(M=M)
    model = DroneModel(scn)
    omegas = model.sample(jax.random.PRNGKey(0), M=M, method="saa")
    us = model.initial_guess().astype(jnp.float64)
    lin = linearize_batch(model, us, omegas)
    n = model.S * model.n_u
    p_diag_u = jnp.tile(2.0 * scn.dt * jnp.diag(scn.R), model.S)
    data = pack_saa_qp_data(lin, us.reshape(-1), p_diag_u, alpha)
    st = SAAQPStatic(
        n=n,
        M=M,
        K=model.K,
        n_fc=model.n_fc,
        n_x=model.n_x,
        row_scale=model.row_scale,
        slack_penalty=10000.0,
        u_max=scn.u_max,
        baseline=baseline,
        baseline_pad=1e-3,
        gate_iters=2,
        gate_scale=1e-7,
        gate_l=-0.1,
        gate_u=0.1,
    )
    return st, data


@pytest.mark.parametrize("baseline", [False, True])
@pytest.mark.parametrize("scp_iter", [0, 3])
def test_structured_matvecs_match_dense(baseline, scp_iter):
    st, data = make_problem(baseline=baseline)
    A, l_d, u_d = dense_reference_A(st, data, scp_iter)
    ops = SAAQPOps(st, data, jnp.asarray(scp_iter))
    l, u = build_bounds(st, data, jnp.asarray(scp_iter))

    np.testing.assert_allclose(np.asarray(l), l_d, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(u), u_d, rtol=1e-12)

    rng = np.random.default_rng(0)
    z = rng.standard_normal(st.n + st.M + 2)
    w = rng.standard_normal(A.shape[0])
    np.testing.assert_allclose(
        np.asarray(ops.matvec_A(jnp.array(z))), A @ z, rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(ops.rmatvec_A(jnp.array(w))), A.T @ w, rtol=1e-10, atol=1e-12
    )


@pytest.mark.parametrize("scp_iter", [0, 3])
def test_schur_kkt_solve_matches_dense(scp_iter):
    st, data = make_problem()
    A, l_d, u_d = dense_reference_A(st, data, scp_iter)
    ops = SAAQPOps(st, data, jnp.asarray(scp_iter))
    l, u = build_bounds(st, data, jnp.asarray(scp_iter))
    p_diag, _ = build_objective(st, data)

    nv = st.n + st.M + 2
    sigma_vec = jnp.full(nv, 1e-6)
    rho_vec = admm.rho_vector(l, u, 0.1)
    N = (
        np.diag(np.asarray(p_diag))
        + np.diag(np.asarray(sigma_vec))
        + A.T @ (np.asarray(rho_vec)[:, None] * A)
    )
    rng = np.random.default_rng(1)
    rhs = rng.standard_normal(nv)
    x_dense = np.linalg.solve(N, rhs)
    factor = ops.factorize(rho_vec, sigma_vec)
    x_schur = ops.kkt_solve(factor, jnp.array(rhs), rho_vec, sigma_vec)
    np.testing.assert_allclose(np.asarray(x_schur), x_dense, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("baseline", [False, True])
def test_structured_solution_matches_dense_admm(baseline):
    """ADMM backend: structured and dense paths agree at OSQP-style moderate
    tolerance (these degenerate epigraph QPs are LP-like, so ADMM converges
    slowly in the tail — the IPM backend covers high accuracy; see
    test_ipm.test_saa_qp_ipm_high_accuracy).

    The baseline method is tested at a gated iteration: ungated baseline
    rows linearized around the initial guess are primal-infeasible (no CVaR
    slack; the reference would print '[solve]: Problem infeasible.' there,
    drone_risk.py:458-459)."""
    st, data = make_problem(baseline=baseline)
    cfg = SolverConfig(eps_abs=1e-4, eps_rel=1e-4, max_iter=40000)
    it = 0 if baseline else 3
    scp_iter = jnp.asarray(it)

    sol_struct = solve_saa_qp(st, data, scp_iter, cfg)
    assert bool(sol_struct.solved)

    A, l_d, u_d = dense_reference_A(st, data, it)
    p_diag, q = build_objective(st, data)
    P = jnp.diag(p_diag)
    sol_dense = admm.solve_dense_qp(
        P, q, jnp.array(A), jnp.array(l_d), jnp.array(u_d), cfg
    )
    assert bool(sol_dense.solved)
    # both near-feasible and with comparable objective
    for sol in (sol_struct, sol_dense):
        Ax = A @ np.asarray(sol.x)
        assert np.max(Ax - u_d) < 1e-3
        assert np.max(l_d - Ax) < 1e-3
    obj = lambda v: 0.5 * np.sum(np.asarray(p_diag) * v * v) + np.asarray(q) @ v
    o_s, o_d = obj(np.asarray(sol_struct.x)), obj(np.asarray(sol_dense.x))
    assert abs(o_s - o_d) <= 1e-3 * (1 + abs(o_d))


def test_kkt_chol_inverse_mode_matches():
    """kkt_chol_inverse (SolverConfig): the per-iteration Schur solve via
    the precomputed explicit inverse must certify and land on the same
    solution as the triangular-solve path (the in-iteration refinement
    contracts both application errors identically)."""
    st, data = make_problem()
    scp_iter = jnp.asarray(3)
    base = SolverConfig(eps_abs=1e-4, eps_rel=1e-4, max_iter=40000)
    inv = SolverConfig(eps_abs=1e-4, eps_rel=1e-4, max_iter=40000,
                       kkt_chol_inverse=True)
    s_b = solve_saa_qp(st, data, scp_iter, base)
    s_i = solve_saa_qp(st, data, scp_iter, inv)
    assert bool(s_b.solved) and bool(s_i.solved)
    np.testing.assert_allclose(
        np.asarray(s_i.x), np.asarray(s_b.x), rtol=1e-3, atol=1e-4
    )


def test_eps_scale_loosens_termination():
    """Inexact-SCP hook (admm.admm_solve eps_scale / SolverConfig
    .eps_sched_iters): a traced eps multiplier must loosen BOTH
    termination thresholds — the scaled solve certifies in fewer
    iterations, and its residuals sit within the scaled tolerance of the
    tight solution's objective."""
    st, data = make_problem()
    # eps 1e-4: these degenerate epigraph QPs are LP-like and ADMM's tail
    # is slow (see test_structured_solution_matches_dense_admm)
    cfg = SolverConfig(eps_abs=1e-4, eps_rel=1e-4, max_iter=40000)
    scp_iter = jnp.asarray(3)

    tight = solve_saa_qp(st, data, scp_iter, cfg)
    loose = solve_saa_qp(st, data, scp_iter, cfg,
                         eps_scale=jnp.asarray(100.0))
    assert bool(tight.solved) and bool(loose.solved)
    assert int(loose.iters) < int(tight.iters)
    # the loose solution is a genuine approximate solution: primal-feasible
    # within the SCALED tolerance (objective closeness is NOT expected —
    # these QPs are LP-like, so a 100x-looser dual residual moves the
    # vertex; the SCP loop re-linearizes around it anyway)
    A, l_d, u_d = dense_reference_A(st, data, 3)
    Ax = A @ np.asarray(loose.x)
    scaled_tol = 100.0 * (1e-4 + 1e-4 * max(np.max(np.abs(Ax)), 1.0))
    assert np.max(Ax - u_d) < scaled_tol
    assert np.max(l_d - Ax) < scaled_tol


def test_factored_refine_mode_solves():
    """kkt_refine_mode='factored' (residual against the stored Schur blocks,
    ~zero extra memory traffic) must still produce accurate KKT solves and a
    certified ADMM solution matching the 'true'-mode solution."""
    st, data = make_problem()
    scp_iter = jnp.asarray(3)
    l, u = build_bounds(st, data, scp_iter)
    p_diag, _ = build_objective(st, data)
    nv = st.n + st.M + 2
    sigma_vec = jnp.full(nv, 1e-6)
    rho_vec = admm.rho_vector(l, u, 0.1)
    rng = np.random.default_rng(2)
    rhs = rng.standard_normal(nv)

    ops_f = SAAQPOps(st, data, scp_iter, kkt_refine_iters=2,
                     kkt_refine_mode="factored")
    factor = ops_f.factorize(rho_vec, sigma_vec)
    x_f = ops_f.kkt_solve(factor, jnp.array(rhs), rho_vec, sigma_vec)
    # residual of the TRUE system after factored-mode refinement
    res = jnp.array(rhs) - (
        ops_f.matvec_P(x_f) + sigma_vec * x_f
        + ops_f.rmatvec_A(rho_vec * ops_f.matvec_A(x_f))
    )
    assert float(jnp.max(jnp.abs(res))) < 1e-9 * max(
        1.0, float(jnp.max(jnp.abs(rhs)))
    )

    # full ADMM equality between the modes on the certifiable gated QP
    # (cold-start post-gating QPs are degenerate and never certify without
    # the SCP loop's warm start — out of scope here)
    cfg_t = SolverConfig(eps_abs=1e-6, eps_rel=1e-6, max_iter=4000,
                         polish=False, kkt_refine_iters=1)
    cfg_f = SolverConfig(eps_abs=1e-6, eps_rel=1e-6, max_iter=4000,
                         polish=False, kkt_refine_iters=1,
                         kkt_refine_mode="factored")
    s_t = solve_saa_qp(st, data, jnp.asarray(0), cfg_t)
    s_f = solve_saa_qp(st, data, jnp.asarray(0), cfg_f)
    assert bool(s_t.solved) and bool(s_f.solved)
    assert int(s_t.iters) == int(s_f.iters)
    np.testing.assert_allclose(
        np.asarray(s_f.x), np.asarray(s_t.x), rtol=1e-6, atol=1e-9,
    )


def test_compensated_factorize_f32():
    """factorize_compensated (auto-on for f32 data) must form the stored
    Schur blocks (N_vv, C) to a few f32 ulps of the exact values for the
    SAME f32-rounded inputs — removing the O(sqrt(M*K))*eps accumulation
    error of the plain einsum path that the 'factored' refinement mode
    cannot observe (ops/saa_qp.py factorize)."""
    st, data = make_problem(M=64)
    scp_iter = jnp.asarray(3)
    f32 = lambda t: jax.tree.map(lambda a: a.astype(jnp.float32), t)
    f64 = lambda t: jax.tree.map(lambda a: a.astype(jnp.float64), t)
    data32 = f32(data)

    l, u = build_bounds(st, data32, scp_iter)
    rho32 = admm.rho_vector(l, u, 0.1).astype(jnp.float32)
    sigma32 = jnp.full(st.n + st.M + 2, 1e-6, jnp.float32)

    # oracle: x64 formation from the identical f32-rounded inputs
    ops64 = SAAQPOps(st, f64(data32), scp_iter)
    _, C64, D64, beta64, Nvv64, _ = ops64.factorize(
        rho32.astype(jnp.float64), sigma32.astype(jnp.float64)
    )

    ops_c = SAAQPOps(st, data32, scp_iter)  # auto: compensated for f32
    assert ops_c.factorize_compensated
    ops_p = SAAQPOps(st, data32, scp_iter, factorize_compensated=False)
    _, C_c, D_c, _, Nvv_c, _ = ops_c.factorize(rho32, sigma32)
    _, C_p, D_p, _, Nvv_p, _ = ops_p.factorize(rho32, sigma32)

    def relerr(a, ref):
        ref = np.asarray(ref)
        return float(
            np.max(np.abs(np.asarray(a, np.float64) - ref))
            / np.max(np.abs(ref))
        )

    err_c, err_p = relerr(Nvv_c, Nvv64), relerr(Nvv_p, Nvv64)
    # few-ulp formation: per-sample K-contraction rounding only
    assert err_c < 1e-6, (err_c, err_p)
    assert err_c <= err_p + 1e-12
    np.testing.assert_allclose(np.asarray(C_c), np.asarray(C64), rtol=0,
                               atol=1e-6 * float(np.max(np.abs(C64))))
    np.testing.assert_allclose(np.asarray(D_c), np.asarray(D64), rtol=1e-5)
