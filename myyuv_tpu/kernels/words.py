"""Packed word layouts of the device codec (plain JAX relayouts).

The frame codec moves every tensor at information density in i32 words:

* pixel frames ``xw [128, NTP]``: block b = 8c + r sits in lane column c,
  sublane r; its 16 pixel words (4 consecutive row pixels each,
  little-endian) are rows 8w + r (``pack_pixel_words``);
* chunk words in STREAM SPACE (bytes bit-reversed, packed big-endian —
  native/block_codec.h) in the same packed-8 row layout: region A
  ``[64, NTP]`` holds every chunk's first 8 words, region C
  ``[8 * cont, NTP]`` its continuation words (``pack_rows8``).

Planes whose block-row width is a multiple of 8 take one 5-D transpose;
other widths go through the block-major rows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import device as kdev

I32 = jnp.int32

# the minimal valid chunk (all-zero block: enc_bits=1, tree = one group
# holding the single symbol 0 of code length 1, payload bit 0) as its
# first stream-space word — filler for pad blocks of region A
FILLER_W0 = np.int32(np.uint32((0x80 << 24) | (0xC0 << 8)).view(np.int32))


def bitrev8(v):
    """Reverse the low 8 bits of each element."""
    v = ((v & 0xF0) >> 4) | ((v & 0x0F) << 4)
    v = ((v & 0xCC) >> 2) | ((v & 0x33) << 2)
    return ((v & 0xAA) >> 1) | ((v & 0x55) << 1)


def pack_rows8(x: jnp.ndarray) -> jnp.ndarray:
    """[n, R] block-major rows -> [R*8, n//8] packed layout (element e of
    block b at row 8e + b%8, lane column b//8)."""
    n, r = x.shape
    return x.T.reshape(r, n // 8, 8).transpose(0, 2, 1).reshape(
        r * 8, n // 8)


def unpack_rows8(xp: jnp.ndarray) -> jnp.ndarray:
    """[R*8, np8] packed -> [np8*8, R] block-major rows."""
    r8, np8 = xp.shape
    return xp.reshape(r8 // 8, 8, np8).transpose(2, 1, 0).reshape(
        np8 * 8, r8 // 8)


def lanes_to_words(lanes: jnp.ndarray) -> jnp.ndarray:
    """[N, 256] u8 chunk lanes -> [N, 64] i32 stream-space words."""
    b = bitrev8(lanes.astype(I32)).reshape(lanes.shape[0], 64, 4)
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) \
        | b[..., 3]


def words_to_lanes(words: jnp.ndarray) -> jnp.ndarray:
    """[N, 64] i32 stream-space words -> [N, 256] u8 chunk lanes."""
    parts = [bitrev8((words >> sh) & 0xFF).astype(jnp.uint8)
             for sh in (24, 16, 8, 0)]
    return jnp.stack(parts, axis=-1).reshape(words.shape[0], 256)


def plane_pids(ny: int, nc: int, pad_cols: int = 0) -> jnp.ndarray:
    """[ny//8 + 2*(nc//8) + pad_cols] i32 plane id (0/1/2) of every lane
    column of a packed Y|U|V frame (pad columns tagged plane 0)."""
    return jnp.asarray(np.concatenate([
        np.zeros(ny // 8, np.int32), np.ones(nc // 8, np.int32),
        np.full(nc // 8, 2, np.int32), np.zeros(pad_cols, np.int32)]))


def stack_qtables(qt_y, qt_u, qt_v) -> jnp.ndarray:
    """Three [8, 8] quantization tables -> [3, 64] f32 (row-major)."""
    return jnp.stack([jnp.asarray(q, jnp.float32).reshape(64)
                      for q in (qt_y, qt_u, qt_v)])


def pack_pixel_words(plane: jnp.ndarray) -> jnp.ndarray:
    """[H, W] u8 plane -> [128, N/8] i32 pixel quad words (packed-8
    layout, 4 consecutive row pixels per word, little-endian)."""
    h, w = plane.shape
    n = (h // 8) * (w // 8)
    wb = w // 8
    v = jax.lax.bitcast_convert_type(
        plane.reshape(h, w // 4, 4), I32)               # [H, W/4]
    if wb % 8 == 0:
        t = v.reshape(h // 8, 8, wb // 8, 8, 2).transpose(1, 4, 3, 0, 2)
        return t.reshape(128, n // 8)
    b16 = v.reshape(h // 8, 8, wb, 2).transpose(0, 2, 1, 3).reshape(n, 16)
    return pack_rows8(b16)


def unpack_pixel_words(xw: jnp.ndarray, ph: int, pw: int) -> jnp.ndarray:
    """[128, n/8] i32 pixel quad words -> [ph, pw] u8 plane."""
    n = xw.shape[1] * 8
    wb = pw // 8
    if wb % 8 == 0:
        v = xw.reshape(8, 2, 8, ph // 8, wb // 8).transpose(
            3, 0, 4, 2, 1).reshape(ph, pw // 4)
        return jax.lax.bitcast_convert_type(v, jnp.uint8).reshape(ph, pw)
    b16 = unpack_rows8(xw)                              # [n, 16]
    b = jax.lax.bitcast_convert_type(b16, jnp.uint8)    # [n, 16, 4]
    return kdev.blocks_to_plane(b.reshape(n, 8, 8), ph, pw)


def words_to_blocks(xw: jnp.ndarray) -> jnp.ndarray:
    """[128, NTP] pixel words -> [8*NTP, 8, 8] u8 blocks (block order)."""
    b16 = unpack_rows8(xw)
    return jax.lax.bitcast_convert_type(b16, jnp.uint8).reshape(-1, 8, 8)


def blocks_to_words(blocks: jnp.ndarray) -> jnp.ndarray:
    """[8*NTP, 8, 8] u8 blocks -> [128, NTP] pixel words."""
    n = blocks.shape[0]
    b16 = jax.lax.bitcast_convert_type(blocks.reshape(n, 16, 4), I32)
    return pack_rows8(b16)
