"""Compressed DCT payload containers: serialized layout + lane converters.

Re-design of the reference's serialized compressed-image layout
(``myyuv_lib/myyuv_DCT/DCT.cpp:16-197``):

  payload  := u32 planes_sizes[3], then 3x Plane
  Plane    := u32 chunks_sizes_size (= number of 8x8 blocks in the plane),
              u32 content_size,
              u8  chunks_sizes[chunks_sizes_size],
              u8  content[content_size]
  block k's chunk starts at the exclusive prefix sum of chunks_sizes[:k]
  (``DCTYUVPlane::getContentPos``, DCT.cpp:21-33).

The device twist: vectorized kernels operate on *fixed-width lanes*
``[num_blocks, MAX_CHUNK]`` uint8 (every per-block Huffman chunk fits in
<= 255 bytes because its size is stored in a u8), and this module converts
between the ragged on-disk layout and dense lanes with vectorized prefix-sum
gather/scatter — the host analog of the cross-chip exclusive scan described
in SURVEY.md §5. A C++ native fast path (runtime.native) is used when built.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..runtime.errors import BitstreamError

MAX_CHUNK = 256  # lane width; chunks are 3..255 bytes (u8 size field)


@dataclasses.dataclass
class DCTPlaneStream:
    """One plane's compressed stream: per-block chunk sizes + packed chunks."""

    chunk_sizes: np.ndarray  # uint8 [num_blocks]
    content: np.ndarray      # uint8 [content_size]

    @property
    def num_blocks(self) -> int:
        return int(self.chunk_sizes.size)

    def total_size(self) -> int:
        # u32 chunks_sizes_size + u32 content_size + sizes + content
        return 8 + self.chunk_sizes.size + self.content.size

    def content_pos(self) -> np.ndarray:
        """Exclusive prefix sum of chunk sizes (DCT.cpp:21-33)."""
        pos = np.zeros(self.num_blocks, np.int64)
        np.cumsum(self.chunk_sizes[:-1], out=pos[1:])
        return pos

    # -- ragged <-> lanes -----------------------------------------------------
    def to_lanes(self) -> np.ndarray:
        """Expand ragged chunks into dense [num_blocks, MAX_CHUNK] lanes."""
        n = self.num_blocks
        sizes = self.chunk_sizes.astype(np.int64)
        pos = self.content_pos()
        lanes = np.zeros((n, MAX_CHUNK), np.uint8)
        idx = pos[:, None] + np.arange(MAX_CHUNK)[None, :]
        mask = np.arange(MAX_CHUNK)[None, :] < sizes[:, None]
        np.clip(idx, 0, self.content.size - 1, out=idx)
        lanes[mask] = self.content[idx[mask]]
        return lanes

    @classmethod
    def from_lanes(cls, lanes: np.ndarray, sizes: np.ndarray) -> "DCTPlaneStream":
        """Compact dense lanes back into the ragged stream."""
        sizes = sizes.astype(np.uint8)
        mask = np.arange(lanes.shape[1])[None, :] < sizes.astype(np.int64)[:, None]
        return cls(chunk_sizes=sizes, content=lanes[mask])

    # -- (de)serialization ------------------------------------------------------
    @classmethod
    def parse(cls, data: np.ndarray) -> "DCTPlaneStream":
        """Parse one serialized plane (DCTYUVPlane::load, DCT.cpp:39-62)."""
        if data.size <= 8:
            raise BitstreamError("DCTYUVPlane load bad size")
        nblk = int(data[:4].view(np.uint32)[0])
        csize = int(data[4:8].view(np.uint32)[0])
        if nblk <= 0:
            raise BitstreamError("DCTYUVPlane load chunks_sizes_size bad size")
        if csize <= 0:
            raise BitstreamError("DCTYUVPlane load content_size bad size")
        if data.size < 8 + nblk + csize:
            raise BitstreamError("DCTYUVPlane load bad size")
        return cls(chunk_sizes=data[8: 8 + nblk].copy(),
                   content=data[8 + nblk: 8 + nblk + csize].copy())

    def serialize(self) -> np.ndarray:
        out = np.empty(self.total_size(), np.uint8)
        out[:4] = np.frombuffer(
            np.uint32(self.num_blocks).tobytes(), np.uint8)
        out[4:8] = np.frombuffer(
            np.uint32(self.content.size).tobytes(), np.uint8)
        out[8: 8 + self.num_blocks] = self.chunk_sizes
        out[8 + self.num_blocks:] = self.content
        return out


@dataclasses.dataclass
class DCTStream:
    """Full 3-plane compressed payload (DCTYUV, DCT.cpp:112-197)."""

    planes: List[Optional[DCTPlaneStream]]

    def total_size(self) -> int:
        return 12 + sum(p.total_size() for p in self.planes if p is not None)

    @classmethod
    def parse(cls, data: np.ndarray) -> "DCTStream":
        """Parse a full payload (DCTYUV::load, DCT.cpp:130-159)."""
        if data.size <= 12:
            raise BitstreamError("DCTYUV load bad size")
        sizes = data[:12].view(np.uint32).astype(np.int64)
        if data.size < 12 + int(sizes.sum()):
            raise BitstreamError("DCTYUV load bad size")
        planes: List[Optional[DCTPlaneStream]] = []
        pos = 12
        for i in range(3):
            if sizes[i] != 0:
                planes.append(DCTPlaneStream.parse(data[pos: pos + sizes[i]]))
                pos += int(sizes[i])
            else:
                planes.append(None)
        return cls(planes)

    def serialize(self) -> np.ndarray:
        chunks = [None, None, None]
        sizes = np.zeros(3, np.uint32)
        for i, p in enumerate(self.planes):
            if p is not None:
                chunks[i] = p.serialize()
                sizes[i] = chunks[i].size
        out = [np.frombuffer(sizes.tobytes(), np.uint8)]
        out += [c for c in chunks if c is not None]
        return np.concatenate(out)
