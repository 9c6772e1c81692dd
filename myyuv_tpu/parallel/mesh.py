"""Device meshes and shardings for the batched codec engine.

The reference's parallelism is OpenMP fork/join over planes and blocks
(DCT.cpp:294-296,399-426). The device mapping (SURVEY.md §2.3): frames
batch over a ``data`` mesh axis, and within large frames the block axis can
shard over a second ``block`` axis; XLA inserts the collectives.

The mesh is the single source of truth for every pjit'd entry point; tests
and the driver's dry-run exercise it on a virtual CPU mesh via
``XLA_FLAGS=--xla_force_host_platform_device_count=N``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
BLOCK_AXIS = "block"


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a (data, block) mesh over the available devices.

    Default: all devices on the data axis, block axis size 1 — pure
    frame-level data parallelism; pass e.g. ``shape=(2, 4)`` to shard the
    block axis of 4K frames over 4 chips each.
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices), 1)
    if shape[0] * shape[1] != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, (DATA_AXIS, BLOCK_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a [B, ...] batch over the data axis, blocks over block axis."""
    return NamedSharding(mesh, P(DATA_AXIS, BLOCK_AXIS))


def plane_batch_spec() -> P:
    """[B, H, W] planes: frames over data, rows (block rows) over block."""
    return P(DATA_AXIS, BLOCK_AXIS, None)


def coeff_batch_spec() -> P:
    """[B, nblk, 8, 8] coefficients: frames over data, blocks over block."""
    return P(DATA_AXIS, BLOCK_AXIS, None, None)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
