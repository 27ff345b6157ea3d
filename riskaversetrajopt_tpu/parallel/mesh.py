"""Device-mesh and sharding layer: SAA sample-parallelism over devices.

The reference's only parallelism is single-process vmap over the M samples
(car/driving.py:206-214, drone/drone_risk.py:157-162). Here the sample axis IS
the data-parallel axis (SURVEY.md section 2.3): the uncertainty pytree is
sharded over a `samples` mesh axis, and XLA GSPMD propagates the sharding
through the vmapped linearization and the structured QP operators — the
per-sample Jacobian stack G (M, K, n) stays chip-local, and the only
communication is the all-reduce of the (n+2)x(n+2) Schur block and the small
CVaR couplings (sum_i y_i, row sums), exactly the Schur-complement
split called for in SURVEY.md section 5.

An optional `batch` axis shards independent problem instances (the
(alpha x repeat) sweep, drone_risk.py:498-503) — the analog of expert-parallel
fan-out.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_sample_devices: Optional[int] = None,
    n_batch_devices: int = 1,
    devices=None,
) -> Mesh:
    """Create a ('batch', 'samples') mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    if n_sample_devices is None:
        n_sample_devices = len(devices) // n_batch_devices
    used = n_sample_devices * n_batch_devices
    dev_array = np.array(devices[:used]).reshape(n_batch_devices, n_sample_devices)
    return Mesh(dev_array, axis_names=("batch", "samples"))


def shard_samples(pytree, mesh: Mesh, batched: bool = False):
    """Place a per-sample pytree with the leading axis sharded over 'samples'
    (and, when `batched`, axis 0 over 'batch' and axis 1 over 'samples')."""
    if batched:
        spec = P("batch", "samples")
    else:
        spec = P("samples")

    def put(leaf):
        ndim = np.ndim(leaf)
        axes = list(spec) + [None] * (ndim - len(spec))
        return jax.device_put(leaf, NamedSharding(mesh, P(*axes)))

    return jax.tree.map(put, pytree)


def replicate(pytree, mesh: Mesh):
    """Fully replicate a pytree over the mesh."""
    return jax.tree.map(
        lambda leaf: jax.device_put(leaf, NamedSharding(mesh, P())), pytree
    )
