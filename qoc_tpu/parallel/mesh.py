"""Device-mesh utilities for multi-device batched optimization.

The reference has no distribution layer at all (SURVEY.md section 2.7) —
this is the genuinely new first-class component.  Scaling comes from
batching optimization seeds / Hamiltonian sweeps over a 1-D
``jax.sharding.Mesh`` on the seed axis: seeds are independent, so the
mesh follows the algorithm alone, and the only collectives are the
all-reduces of aggregate metrics.  Runs over several hosts initialize
with ``jax.distributed`` and shard the same seed axis across them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


BATCH_AXIS = "batch"


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = BATCH_AXIS,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """1-D mesh over the seed/sweep batch axis (the natural GRAPE sharding:
    each problem instance is independent; no collectives inside the step,
    psum only for aggregate metrics)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def batch_sharding(mesh: Mesh, axis_name: str = BATCH_AXIS) -> NamedSharding:
    """Shard the leading (seed) axis; replicate everything else."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def init_distributed(**kwargs) -> None:
    """Multi-host entry: call once per process before touching devices.

    Thin wrapper over ``jax.distributed.initialize``: pass the
    coordinator address (``host:port``), ``num_processes`` and
    ``process_id`` explicitly where no cluster environment provides them.
    """
    jax.distributed.initialize(**kwargs)
