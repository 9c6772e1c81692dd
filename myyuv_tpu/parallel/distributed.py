"""Multi-host orchestration: initialization, sharded batches, ragged gather.

The reference is single-process (SURVEY.md §2.3); this module is the
framework's scale-out story:

* ``initialize`` wraps ``jax.distributed.initialize`` (no-op when
  single-process, e.g. tests and the single-chip dev box).
* ``shard_batch``/``gather_streams`` implement the multi-host ragged
  gather of SURVEY.md §8 item 5: every host compresses its local frames,
  chunk-size tables are all-gathered, and offsets are assigned by a global
  exclusive prefix sum (the cross-host generalization of
  DCTYUVPlane::getContentPos, DCT.cpp:21-33) so any host can assemble a
  valid single-file ``.myyuv`` payload.
* global RD statistics (symbol histograms, SSE) ride the replicated-output
  shardings of engine.batch.make_sharded_roundtrip — XLA lowers them to
  psum over NVLink within a host and the network across hosts.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from . import mesh as meshlib


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Multi-process JAX init; safe no-op for single-process runs."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)


def process_info() -> Tuple[int, int]:
    return jax.process_index(), jax.process_count()


def local_shard(n_items: int) -> Tuple[int, int]:
    """[start, stop) of this host's share of a global batch."""
    pid, pcount = process_info()
    per = (n_items + pcount - 1) // pcount
    return min(pid * per, n_items), min((pid + 1) * per, n_items)


def allgather_sizes(local_sizes: np.ndarray) -> List[np.ndarray]:
    """All hosts' chunk-size tables (host-side collective).

    Single-process: identity. Multi-process: pads to the max host
    length before the collective — ``process_allgather`` requires
    uniform shapes/dtypes, and shard sizes are uneven whenever the
    batch doesn't divide the host count (a tail host may even be
    EMPTY; found by tests/test_distributed_multiprocess.py's 4-process
    case — the unpadded gather aborts in gloo with a size mismatch).
    """
    local_sizes = np.ascontiguousarray(local_sizes)
    if jax.process_count() == 1:
        return [local_sizes]
    from jax.experimental import multihost_utils as mh
    n = mh.process_allgather(
        np.array([local_sizes.size], np.int64)).reshape(-1)
    mx = max(int(n.max()), 1)
    pad = np.zeros(mx, np.int64)
    pad[: local_sizes.size] = local_sizes
    allp = mh.process_allgather(pad).reshape(-1, mx)
    dt = local_sizes.dtype if local_sizes.size else np.uint8
    return [allp[p, : int(n[p])].astype(dt) for p in range(allp.shape[0])]


def global_offsets(all_sizes: Sequence[np.ndarray]) -> np.ndarray:
    """Per-host byte offset of each host's content in the merged stream."""
    totals = np.array([int(s.astype(np.int64).sum()) for s in all_sizes],
                      np.int64)
    return np.concatenate([[0], np.cumsum(totals)[:-1]])


def shard_batch(batch_np: np.ndarray, mesh,
                spec: Optional[P] = None) -> jax.Array:
    """Place a host batch onto the mesh, frames over the ``data`` axis.

    Single-process (incl. the virtual CPU mesh): a sharded ``device_put``.
    Multi-process: each host contributes its process-local shard and the
    result is a global jax.Array spanning every host's devices.
    """
    spec = spec if spec is not None else P(meshlib.DATA_AXIS)
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(batch_np, sharding)
    from jax.experimental import multihost_utils
    return multihost_utils.host_local_array_to_global_array(
        batch_np, mesh, spec)


def gather_streams(local_sizes: np.ndarray, local_content: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-host compressed streams into the global (sizes, content).

    The cross-host generalization of ``DCTYUVPlane::getContentPos``
    (DCT.cpp:21-33): chunk-size tables and content segments are
    all-gathered (padded to the max host length — process_allgather needs
    uniform shapes), and each host's segment lands at the exclusive
    prefix sum of the preceding hosts' byte totals, so EVERY host can
    assemble the same valid single-file payload. Single-process: identity.
    """
    local_sizes = np.ascontiguousarray(local_sizes)
    local_content = np.ascontiguousarray(local_content, np.uint8)
    if jax.process_count() == 1:
        return local_sizes, local_content
    from jax.experimental import multihost_utils as mh
    lens = mh.process_allgather(
        np.array([local_sizes.size, local_content.size], np.int64))
    lens = lens.reshape(-1, 2)
    # pads must be >= 1 element and a HOST-UNIFORM dtype (int64), or an
    # empty/odd-dtype host desynchronizes the collective (gloo aborts)
    max_n = max(int(lens[:, 0].max()), 1)
    max_c = max(int(lens[:, 1].max()), 1)
    pad_s = np.zeros(max_n, np.int64)
    pad_s[: local_sizes.size] = local_sizes
    pad_c = np.zeros(max_c, np.uint8)
    pad_c[: local_content.size] = local_content
    all_s = mh.process_allgather(pad_s).reshape(-1, max_n)
    all_c = mh.process_allgather(pad_c).reshape(-1, max_c)
    dt = local_sizes.dtype if local_sizes.size else np.uint8
    sizes = np.concatenate(
        [all_s[p, : int(lens[p, 0])] for p in range(lens.shape[0])]
    ).astype(dt)
    content = np.concatenate(
        [all_c[p, : int(lens[p, 1])] for p in range(lens.shape[0])])
    return sizes, content
