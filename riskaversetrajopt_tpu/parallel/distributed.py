"""Multi-host runtime: jax.distributed initialization, global meshes, and
process-local data placement.

The reference is strictly single-process (jax_platform_name pinned to 'cpu'
in every script header, car/driving.py:18); its only parallelism is vmap over
the M samples. The multi-host equivalent (SURVEY.md section 2.3, row
"Distributed comm backend") is:

- `jax.distributed.initialize` over DCN for process discovery,
- one global ('batch', 'samples') Mesh spanning every chip of every host,
  host-major, so the `samples` axis shards host-locally first and the SAA
  reductions (the (n+2)^2 Schur block, sum_i y_i, CVaR row sums — see
  ops/saa_qp.py) stay within a host before crossing the network,
- process-local data placement: each host materializes only its own M/num
  hosts slice of the uncertainty pytree and the global array is assembled
  with `jax.make_array_from_process_local_data` (no host ever holds the full
  (M, K, n) Jacobian stack).

On CPU the same code paths run multi-process with gloo collectives — that is
how tests/test_distributed.py validates the layer without a GPU cluster
(SURVEY.md section 4's prescription). Run

    python -m riskaversetrajopt_tpu.parallel.distributed --selftest ...

as one worker of such a pod-simulation (the test spawns two).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Initialize the JAX distributed runtime (idempotent).

    With no arguments, jax auto-discovers cluster topology where a cluster
    manager describes it, and degrades to single-process elsewhere. Explicit
    arguments support simulated pods (multi-process CPU with gloo
    collectives) and bring-your-own cluster managers via the standard
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars.
    """
    global _initialized
    if _initialized:
        return
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        # single process: nothing to connect, but mark initialized so the
        # calling code path is identical on 1 host and N hosts
        _initialized = True
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _initialized = True


def is_initialized() -> bool:
    return _initialized


def global_devices_host_major() -> np.ndarray:
    """All devices ordered (process, local id) so a flattened mesh axis
    shards host-locally first."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return np.array(devs)


def global_mesh(n_batch_devices: int = 1) -> Mesh:
    """('batch', 'samples') mesh over every chip of every host, host-major
    along `samples`. With n_batch_devices > 1 the leading devices split into
    a batch axis for independent-problem fan-out (the (alpha x repeat)
    sweep)."""
    devs = global_devices_host_major()
    n_samples = len(devs) // n_batch_devices
    used = n_samples * n_batch_devices
    return Mesh(
        devs[:used].reshape(n_batch_devices, n_samples),
        axis_names=("batch", "samples"),
    )


def process_sample_slice(M: int) -> slice:
    """The [start, stop) sample range this process owns under a host-major
    `samples` sharding of M total samples."""
    nproc = jax.process_count()
    per = M // nproc
    if per * nproc != M:
        raise ValueError(f"M={M} not divisible by process count {nproc}")
    pid = jax.process_index()
    return slice(pid * per, (pid + 1) * per)


def shard_samples_global(local_pytree, mesh: Mesh, M: int, batched: bool = False):
    """Assemble globally-sharded arrays from per-process local sample chunks.

    `local_pytree` leaves carry this process's slice of the leading sample
    axis (shape (M/num_processes, ...)); the result is a global array of
    leading dim M sharded over the mesh's 'samples' axis. Single-process
    meshes take the fast path through device_put."""
    spec = P("batch", "samples") if batched else P("samples",)

    def put(leaf):
        ndim = np.ndim(leaf)
        axes = list(spec)[: min(len(spec), ndim)] + [None] * (
            ndim - len(spec)
        )
        sh = NamedSharding(mesh, P(*axes))
        if jax.process_count() == 1:
            return jax.device_put(leaf, sh)
        global_shape = (M,) + tuple(np.shape(leaf)[1:])
        return jax.make_array_from_process_local_data(sh, leaf, global_shape)

    return jax.tree.map(put, local_pytree)


def replicate_global(pytree, mesh: Mesh):
    """Fetch a (possibly sharded) computation output as fully-replicated
    host-local numpy — works across processes."""
    rep = jax.jit(
        lambda x: x, out_shardings=NamedSharding(mesh, P())
    )(pytree)
    return jax.tree.map(np.asarray, rep)


# ---------------------------------------------------------------------------
# selftest worker (spawned by tests/test_distributed.py, 2-process CPU pod)
# ---------------------------------------------------------------------------


def replicate_to_mesh(pytree, mesh: Mesh):
    """Place host-local arrays fully replicated on a (possibly multi-process)
    mesh. Every process must hold the identical full value."""
    def put(leaf):
        arr = np.asarray(leaf)
        sh = NamedSharding(mesh, P())
        return jax.make_array_from_callback(
            arr.shape, sh, lambda idx: arr[idx]
        )
    return jax.tree.map(put, pytree)


def selftest_problem(M: int = 16):
    """Deterministic synthetic structured SAA QP shared by the 2-process
    pod selftest and its single-process ground truth (numpy RNG — identical
    on every process, no device dependence)."""
    from riskaversetrajopt_tpu.ops.saa_qp import SAAQPData, SAAQPStatic

    n, K, n_fc = 12, 6, 4
    rng = np.random.default_rng(42)
    st = SAAQPStatic(
        n=n, M=M, K=K, n_fc=n_fc, n_x=3, row_scale=0.01,
        slack_penalty=1e4, u_max=1.0, baseline=False, baseline_pad=0.0,
        gate_iters=2, gate_scale=1e-7, gate_l=-0.1, gate_u=0.1,
    )
    data = SAAQPData(
        F=rng.standard_normal((n_fc, n)) * 0.3,
        f_rhs=rng.standard_normal(n_fc) * 0.1,
        G=rng.standard_normal((M, K, n)),
        g_up=rng.uniform(0.5, 1.5, (M, K)),
        p_diag_u=rng.uniform(0.2, 1.0, n),
        alpha=np.float64(0.2),
    )
    return st, data


def _selftest(coordinator: str, num_processes: int, process_id: int) -> None:
    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass  # newer jax defaults to gloo when distributed is on
    jax.config.update("jax_enable_x64", True)
    initialize(coordinator, num_processes, process_id)

    import jax.numpy as jnp

    if os.environ.get("RATO_DIST_FULL"):
        _selftest_full_scp(process_id)
        return
    if os.environ.get("RATO_DIST_BATCH"):
        _selftest_batch(process_id)
        return

    # Default: one structured SAA QP solve on the global mesh. This
    # exercises everything the distributed layer owns — multi-process mesh
    # construction, make_array_from_process_local_data assembly of the
    # sample-sharded (M, K, n) stack, and the cross-process psum reductions
    # inside the Schur-complement factorize — without paying the
    # multi-minute XLA compile of the full SCP scan in every worker (the
    # full path deadlined CI; run it manually with RATO_DIST_FULL=1).
    from riskaversetrajopt_tpu.core.config import SolverConfig
    from riskaversetrajopt_tpu.ops.saa_qp import solve_saa_qp

    M = 16
    st, data = selftest_problem(M)
    sl = process_sample_slice(M)
    mesh = global_mesh()
    sharded = shard_samples_global(
        {"G": data.G[sl], "g_up": data.g_up[sl]}, mesh, M
    )
    rep = replicate_to_mesh(
        {"F": data.F, "f_rhs": data.f_rhs, "p": data.p_diag_u}, mesh
    )
    cfg = SolverConfig(eps_abs=1e-8, eps_rel=1e-8, max_iter=8000)

    @jax.jit
    def run(G, g_up, F, f_rhs, p):
        d = data._replace(
            G=G, g_up=g_up, F=F, f_rhs=f_rhs, p_diag_u=p,
            alpha=jnp.asarray(0.2, jnp.float64),
        )
        return solve_saa_qp(st, d, jnp.asarray(3), cfg).x

    x = run(sharded["G"], sharded["g_up"], rep["F"], rep["f_rhs"], rep["p"])
    x = replicate_global(x, mesh)
    print(
        f"SELFTEST_OK pid={process_id} nproc={jax.process_count()} "
        f"ndev={jax.device_count()} us_sum={float(np.sum(x)):.12e}",
        flush=True,
    )


def _selftest_batch(process_id: int) -> None:
    """Independent-problem fan-out with the `batch` mesh axis spanning
    PROCESSES — the reference's (alpha x repeat) sweep axis
    (drone_risk.py:498-503) distributed across hosts: each host owns one
    sweep instance (its whole sample axis chip-local), the vmapped solve
    runs as one global program, and every process recovers the full
    result set. Mesh: global_mesh(n_batch_devices=nproc) reshapes the
    host-major device list to (batch=nproc, samples=ndev/nproc), so the
    batch blocks coincide with process boundaries."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from riskaversetrajopt_tpu.core.config import SolverConfig
    from riskaversetrajopt_tpu.ops.saa_qp import solve_saa_qp

    B = jax.process_count()
    M = 16
    st, data = selftest_problem(M)
    # distinct instances per batch element: the reference sweep varies
    # alpha; vary the bounds too so the solutions differ materially
    alphas = np.array([0.1 + 0.2 * b for b in range(B)])
    gups = np.stack([data.g_up * (1.0 + 0.1 * b) for b in range(B)])
    Gs = np.broadcast_to(data.G, (B,) + data.G.shape)

    mesh = global_mesh(n_batch_devices=B)

    def put(local, gshape, spec):
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), np.ascontiguousarray(local), gshape
        )

    pid = process_id
    G_g = put(Gs[pid:pid + 1], Gs.shape, P("batch", "samples"))
    gup_g = put(gups[pid:pid + 1], gups.shape, P("batch", "samples"))
    al_g = put(alphas[pid:pid + 1], alphas.shape, P("batch"))
    rep = replicate_to_mesh(
        {"F": data.F, "f_rhs": data.f_rhs, "p": data.p_diag_u}, mesh
    )
    # fixed-cadence rho epochs: vmapped (lockstep) solves desynchronize
    # under the event-driven refactorization handshake
    # (SolverConfig.rho_epoch_every notes)
    cfg = SolverConfig(eps_abs=1e-8, eps_rel=1e-8, max_iter=8000,
                       rho_epoch_every=50)

    @jax.jit
    def run(G, g_up, al, F, f_rhs, p):
        def one(G_i, gup_i, a_i):
            d = data._replace(
                G=G_i, g_up=gup_i, F=F, f_rhs=f_rhs, p_diag_u=p, alpha=a_i
            )
            return solve_saa_qp(st, d, jnp.asarray(3), cfg).x

        return jax.vmap(one)(G, g_up, al)

    x = run(G_g, gup_g, al_g, rep["F"], rep["f_rhs"], rep["p"])
    x = replicate_global(x, mesh)
    sums = " ".join(
        f"us_sum{b}={float(np.sum(np.asarray(x)[b])):.12e}" for b in range(B)
    )
    print(
        f"SELFTEST_BATCH_OK pid={process_id} nproc={jax.process_count()} "
        f"ndev={jax.device_count()} {sums}",
        flush=True,
    )


def _selftest_full_scp(process_id: int) -> None:
    """Full SCP solve across the pod (slow: each worker compiles the whole
    jitted SCP scan — ~15 min on CPU x64). Manual validation only."""
    import jax.numpy as jnp

    from riskaversetrajopt_tpu.core.config import DroneScenario, SCPConfig
    from riskaversetrajopt_tpu.models.drone import DroneModel
    from riskaversetrajopt_tpu.scp.driver import SAATrajOpt

    model = DroneModel(DroneScenario())
    opt = SAATrajOpt(
        model,
        method="saa",
        scp_cfg=SCPConfig(
            num_iters=6, gate_iters=2, gate_row_scale=1e-7,
            gate_bound_l=-0.1, gate_bound_u=0.1,
        ),
    )
    M = 16
    # every process draws the same full sample set, keeps only its slice
    om_full = opt.sample(jax.random.PRNGKey(0), M=M)
    sl = process_sample_slice(M)
    om_local = jax.tree.map(lambda x: np.asarray(x)[sl], om_full)

    mesh = global_mesh()
    om_sharded = shard_samples_global(om_local, mesh, M)
    res = opt.solve(om_sharded, alpha=jnp.asarray(0.2, jnp.float64))
    us = replicate_global(res.us, mesh)
    print(
        f"SELFTEST_OK pid={process_id} nproc={jax.process_count()} "
        f"ndev={jax.device_count()} us_sum={float(np.sum(us)):.12e}",
        flush=True,
    )


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--coordinator", default="localhost:9932")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, required=True)
    args = ap.parse_args()
    if args.selftest:
        _selftest(args.coordinator, args.num_processes, args.process_id)
