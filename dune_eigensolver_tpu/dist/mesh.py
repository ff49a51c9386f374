"""Device mesh helpers for row-partitioned execution."""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

ROW_AXIS = "rows"


def init_distributed(**kw) -> None:
    """Multi-process startup: call once per process before any jax use
    (wraps ``jax.distributed.initialize``). Pass ``coordinator_address``
    (e.g. ``"localhost:<port>"``), ``num_processes`` and ``process_id``
    in ``kw``: nothing in the environment supplies them. One process can
    also drive all the GPUs of a host without this call. The reference
    deliberately never initializes MPI ("DO NOT INITIALIZE MPI, it starts
    some threads!", src/dune-eigensolver.cc:742-748); after this call
    ``jax.devices()`` spans every process and ``make_mesh()`` builds a
    global mesh whose collectives XLA hands to NCCL."""
    jax.distributed.initialize(**kw)


def make_mesh(n_devices: Optional[int] = None, axis: str = ROW_AXIS) -> Mesh:
    """1D mesh over the first ``n_devices`` devices. Row partitioning is the
    natural decomposition for the tall-skinny workloads here: the matrix and
    multivector rows shard; the m (RHS) dimension stays local to keep every
    Gram matmul a single-device matmul + one psum. The GPUs of one host are
    joined all to all by NVLink, so the device order does not matter."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(
            f"make_mesh: requested {n_devices} devices but only "
            f"{len(devs)} are visible on backend {jax.default_backend()!r}"
        )
    return Mesh(np.array(devs[:n_devices]), (axis,))
