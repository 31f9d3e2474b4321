"""Device-mesh helpers and multi-host initialization.

The reference has **no** distributed subsystem at all (SURVEY.md §2.3 — no
threads, no MPI/NCCL, single-core scalar C).  This module is therefore a
first-class new component, not a port: scale-out is expressed as a
`jax.sharding.Mesh` whose axes name the two forms of spectral parallelism:

* ``data``  — batch sharding: independent transforms on different chips.
* ``seq``   — transform sharding: one long transform split across chips via
  the four-step transpose decomposition (see :mod:`.distributed`), the
  spectral analogue of sequence parallelism.

Collectives ride the devices' interconnect (NVLink between the GPUs of one
host); multi-host meshes additionally cross the network, which
`jax.distributed.initialize` sets up.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (DATA_AXIS, SEQ_AXIS),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a mesh over the available devices.

    ``shape=None`` puts every device on the first axis (pure batch
    parallelism) and size-1 on the rest.  Pass e.g. ``shape=(2, 4)`` for a
    2-way-data x 4-way-sequence layout on 8 chips.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != device count {n}")
    arr = np.asarray(devices, dtype=object).reshape(shape)
    return Mesh(arr, tuple(axis_names))


def batch_sharding(mesh: Mesh, axis_name: str = DATA_AXIS, ndim: int = 2) -> NamedSharding:
    """NamedSharding that shards the leading (batch) axis over ``axis_name``."""
    spec = P(axis_name, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully-replicated sharding on ``mesh`` (for params/constants)."""
    return NamedSharding(mesh, P())


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join a multi-host run (DCN).  No-op on a single host.

    The reference has nothing analogous; this wraps
    ``jax.distributed.initialize`` so multi-host callers get a global mesh
    spanning all hosts' devices from :func:`make_mesh`.
    Returns (process_index, process_count).
    """
    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()
