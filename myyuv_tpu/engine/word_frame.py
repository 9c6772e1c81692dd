"""Word-contract frames: the i32-packed device-resident frame format.

A device-resident frame IS one packed word tensor

    xw [128, NTP] i32 — pixel quad words in the packed-8 block layout
    (block b = c*8 + r at sublane r%8 of rows 16k..16k+7, lane column
    c; 4 consecutive row pixels per word, little-endian — exactly
    kernels/words.pack_pixel_words' output), columns ordered
    [Y | U | V] plane-major and right-padded to ``codec.COLS``.

With frames born in this layout (ingest converts into it, preview
converts out of it — engine/streaming pipelines), the codec roundtrip
is the two fused kernels of kernels/codec and NOTHING else: compress
consumes xw verbatim (DCT+quantize+Huffman-encode) and decompress emits
it verbatim (Huffman-decode+dequantize+IDCT). No pack, no unpack.

The pad columns carry zero-pixel blocks on creation; after a roundtrip
their content is the codec image of zero blocks — consumers address
frames through ``unpack_frame``/plane slices, which never read pad
columns. Reference semantics unchanged: the interchange (A, C, sizes)
is byte-identical to engine/device_stream.compress_frame on the same
pixels (same kernels, same inputs), so every oracle-interop and
bit-exactness guarantee carries over (DCT.cpp:269-335,
Huffman.cpp:105-154,172-241).

``impl`` selects the codec kernel implementation (kernels/codec.IMPLS;
None = the platform's default).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import device_stream as ds
from ..kernels import codec
from ..kernels import words


def frame_cols(h: int, w: int):
    """(luma columns, chroma columns per plane, padded total NTP) of the
    packed word layout for an h x w IYUV frame (h, w divisible by 16).
    NTP aligns to the kernels' thread-block width ``codec.COLS``."""
    ny8 = (h // 8) * (w // 8) // 8
    nc8 = (h // 16) * (w // 16) // 8
    ntot = ny8 + 2 * nc8
    return ny8, nc8, ntot + ((-ntot) % codec.COLS)


def _pad_cols(xw: jnp.ndarray, ntp: int) -> jnp.ndarray:
    pad = ntp - xw.shape[1]
    if pad:
        xw = jnp.concatenate([xw, jnp.zeros((128, pad), jnp.int32)], axis=1)
    return xw


@jax.jit
def pack_frame(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """u8 planes -> xw [128, NTP] word frame (the format boundary: file
    loads and legacy plane APIs enter the word contract here)."""
    h, w = y.shape
    _, _, ntp = frame_cols(h, w)
    uv = jnp.concatenate([u, v], axis=0)
    xw = jnp.concatenate([words.pack_pixel_words(y),
                          words.pack_pixel_words(uv)], axis=1)
    return _pad_cols(xw, ntp)


@functools.partial(jax.jit, static_argnames=("h", "w"))
def unpack_frame(xw: jnp.ndarray, h: int, w: int):
    """xw word frame -> (y, u, v) u8 planes (pad columns never read)."""
    ny8, nc8, _ = frame_cols(h, w)
    yp = words.unpack_pixel_words(xw[:, :ny8], h, w)
    uvp = words.unpack_pixel_words(xw[:, ny8:ny8 + 2 * nc8], h, w // 2)
    return yp, uvp[:h // 2], uvp[h // 2:]


@jax.jit
def bgrx_to_frame(pixels: jnp.ndarray):
    """[H, W, 4] u8 BGRX -> xw word frame: the word-contract INGEST
    conversion (kernels/device.bgrx_to_iyuv, then the word packing)."""
    from ..kernels import device as kdev
    return pack_frame(*kdev.bgrx_to_iyuv(pixels))


@functools.partial(jax.jit, static_argnames=("h", "w"))
def frame_to_bgrx(xw: jnp.ndarray, h: int, w: int):
    """xw word frame -> [H, W, 4] u8 BGRX: the word-contract PREVIEW
    conversion. The barrier keeps XLA from merging the unpack relayout
    into the conversion's channel math (the same pathology as
    kernels/device.unfuse)."""
    from ..kernels import device as kdev
    y, u, v = unpack_frame(xw, h, w)
    y, u, v = jax.lax.optimization_barrier((y, u, v))
    return kdev.iyuv_to_bgrx(y, u, v)


def _qts_pids(qt_y, qt_u, qt_v, h: int, w: int, ntp: int):
    ny8, nc8, _ = frame_cols(h, w)
    return (words.stack_qtables(qt_y, qt_u, qt_v),
            words.plane_pids(8 * ny8, 8 * nc8, ntp - ny8 - 2 * nc8))


def _window_ok(sizes, C):
    """Chunks larger than the decode window (8 + C rows / 8 words) are
    not decodable from the interchange."""
    cw = 8 + C.shape[0] // 8
    cwrows = (sizes.astype(jnp.int32) + 4 * ds.ALIGN_W - 1) \
        // (4 * ds.ALIGN_W)
    return jnp.all(cwrows <= cw // ds.ALIGN_W)


@functools.partial(jax.jit, static_argnames=("h", "w", "cont", "impl"))
def compress_words(xw: jnp.ndarray, qt_y, qt_u, qt_v, h: int, w: int,
                   cont: int = ds.CONT_DEFAULT, impl: str | None = None):
    """Word frame -> (contentA, contentC, sizes, total, ok): the dense
    two-region interchange, byte-identical to compress_frame on the
    same pixels. Compress IS the fused encode kernel."""
    ny8, nc8, _ = frame_cols(h, w)
    n = 8 * (ny8 + 2 * nc8)
    qts, pids = _qts_pids(qt_y, qt_u, qt_v, h, w, xw.shape[1])
    A, C, sizes, ok = codec.encode(xw, qts, pids, cont, impl=impl)
    sizes = sizes[:n]
    return A, C, sizes, jnp.sum(sizes), jnp.all(ok[:n])


@functools.partial(jax.jit, static_argnames=("h", "w", "impl"))
def decompress_words(contentA: jnp.ndarray, contentC: jnp.ndarray,
                     sizes: jnp.ndarray, qt_y, qt_u, qt_v,
                     h: int, w: int, impl: str | None = None):
    """Dense interchange -> (xw word frame, ok). Decompress IS the fused
    decode kernel — its [128, NTP] pixel quad-word output is the frame."""
    ny8, nc8, _ = frame_cols(h, w)
    n = 8 * (ny8 + 2 * nc8)
    qts, pids = _qts_pids(qt_y, qt_u, qt_v, h, w, contentA.shape[1])
    xw, ok = codec.decode(contentA, contentC, qts, pids, impl=impl)
    return xw, jnp.all(ok[:n]) & _window_ok(sizes, contentC)


@functools.partial(jax.jit, static_argnames=("h", "w", "cont", "impl"))
def roundtrip_words(xw: jnp.ndarray, qt_y, qt_u, qt_v, h: int, w: int,
                    cont: int = ds.CONT_DEFAULT, impl: str | None = None):
    """Whole word-contract roundtrip as ONE executable -> (xw', total,
    ok): the transcode/RD loop entry on the word contract — two fused
    kernels back to back, zero relayouts."""
    A, C, sizes, total, ok = compress_words(
        xw, qt_y, qt_u, qt_v, h=h, w=w, cont=cont, impl=impl)
    rxw, dok = decompress_words(A, C, sizes, qt_y, qt_u, qt_v,
                                h=h, w=w, impl=impl)
    return rxw, total, ok & dok


@functools.partial(jax.jit, static_argnames=("h", "w", "cont", "impl"))
def ingest_frame(pixels: jnp.ndarray, qt_y, qt_u, qt_v, h: int, w: int,
                 cont: int = ds.CONT_DEFAULT, impl: str | None = None):
    """BGRX pixels -> interchange in ONE executable (bgrx_to_frame +
    compress_words fused): the capture pipeline's per-frame dispatch."""
    return compress_words(bgrx_to_frame(pixels), qt_y, qt_u, qt_v,
                          h=h, w=w, cont=cont, impl=impl)


@functools.partial(jax.jit, static_argnames=("h", "w", "impl"))
def preview_frame(contentA: jnp.ndarray, contentC: jnp.ndarray,
                  sizes: jnp.ndarray, qt_y, qt_u, qt_v, h: int, w: int,
                  impl: str | None = None):
    """Interchange -> BGRX preview in ONE executable (decompress_words
    + frame_to_bgrx fused; the unpack/convert barrier inside
    frame_to_bgrx is preserved): the playback pipeline's per-frame
    dispatch. Returns (bgrx, ok)."""
    xw, ok = decompress_words(contentA, contentC, sizes,
                              qt_y, qt_u, qt_v, h=h, w=w, impl=impl)
    return frame_to_bgrx(xw, h, w), ok


# ---------------------------------------------------------------------------
# Sharded word-contract codec: lane columns over the device mesh
# ---------------------------------------------------------------------------
#
# The word layout makes sharding trivial: splitting xw's lane COLUMNS
# over the mesh gives every device a contiguous block range (block
# b = c*8 + r), so each shard body is just the fused kernels on its
# slab — no per-device pack/unpack (the plane-row sharding of
# engine/sharded_stream pays both), and assembly is concatenation in
# mesh order = the global stream order. The mesh generalization of the
# reference's OpenMP block loop (DCT.cpp:294-296) on the word contract.


def pad_frame_cols(xw: jnp.ndarray, n_dev: int) -> jnp.ndarray:
    """Right-pad a word frame's columns to a multiple of
    n_dev * codec.COLS so every device's slab is a whole number of
    kernel thread blocks (pad columns are zero blocks = valid ignorable
    chunks)."""
    return _pad_cols(xw, xw.shape[1] + (-xw.shape[1]) % (codec.COLS * n_dev))


_WORD_SHARDED_CACHE = {}


def _word_sharded(mesh, ntps: int, cont: int, impl: str | None):
    """(compress, decompress) shard_map jits for an ntps-column frame
    (cached per geometry — shard_map closures retrace per call)."""
    key = (id(mesh), ntps, cont, impl)
    if key in _WORD_SHARDED_CACHE:
        return _WORD_SHARDED_CACHE[key]
    from jax.sharding import PartitionSpec as P
    from ..parallel import mesh as meshlib
    axes = (meshlib.DATA_AXIS, meshlib.BLOCK_AXIS)
    shc = P(None, axes)
    shp = P(axes)
    rep = P()

    def cbody(xw_l, qts, pids_l):
        A, C, sizes, ok = codec.encode(xw_l, qts, pids_l, cont, impl=impl)
        return A, C, sizes, ok.astype(jnp.int32)

    def dbody(A_l, C_l, qts, pids_l):
        xw_l, ok = codec.decode(A_l, C_l, qts, pids_l, impl=impl)
        return xw_l, ok.astype(jnp.int32)

    compress = jax.jit(jax.shard_map(
        cbody, mesh=mesh, check_vma=False,
        in_specs=(shc, rep, shp), out_specs=(shc, shc, shp, shp)))
    decompress = jax.jit(jax.shard_map(
        dbody, mesh=mesh, check_vma=False,
        in_specs=(shc, shc, rep, shp), out_specs=(shc, shp)))
    _WORD_SHARDED_CACHE[key] = (compress, decompress)
    return compress, decompress


def _sharded_inputs(mesh, qt_y, qt_u, qt_v, h: int, w: int, ntps: int):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ..parallel import mesh as meshlib
    qts, pids = _qts_pids(qt_y, qt_u, qt_v, h, w, ntps)
    axes = (meshlib.DATA_AXIS, meshlib.BLOCK_AXIS)
    return qts, jax.device_put(pids, NamedSharding(mesh, P(axes)))


def compress_words_sharded(mesh, xw: jnp.ndarray, qt_y, qt_u, qt_v,
                           h: int, w: int, cont: int = ds.CONT_DEFAULT,
                           impl: str | None = None):
    """Sharded word-contract compress: xw [128, NTPS] (pad_frame_cols
    geometry) -> (A, C, sizes[:n live], total, ok) — byte-identical
    chunks to the single-device compress_words."""
    ny8, nc8, _ = frame_cols(h, w)
    n = 8 * (ny8 + 2 * nc8)
    qts, pids = _sharded_inputs(mesh, qt_y, qt_u, qt_v, h, w, xw.shape[1])
    compress, _ = _word_sharded(mesh, xw.shape[1], cont, impl)
    with mesh:
        A, C, sizes, ok = compress(xw, qts, pids)
    sizes = sizes[:n]
    return A, C, sizes, jnp.sum(sizes), jnp.all(ok[:n] != 0)


def decompress_words_sharded(mesh, A: jnp.ndarray, C: jnp.ndarray,
                             sizes: jnp.ndarray, qt_y, qt_u, qt_v,
                             h: int, w: int, impl: str | None = None):
    """Sharded word-contract decompress -> (xw [128, NTPS], ok)."""
    ny8, nc8, _ = frame_cols(h, w)
    n = 8 * (ny8 + 2 * nc8)
    qts, pids = _sharded_inputs(mesh, qt_y, qt_u, qt_v, h, w, A.shape[1])
    _, decompress = _word_sharded(mesh, A.shape[1], C.shape[0] // 8, impl)
    with mesh:
        xw, ok = decompress(A, C, qts, pids)
    return xw, jnp.all(ok[:n] != 0) & _window_ok(sizes, C)


@functools.partial(jax.jit, static_argnames=("h", "w", "cont", "impl"))
def roundtrip_words_scan(xws: jnp.ndarray, qt_y, qt_u, qt_v,
                         h: int, w: int, cont: int = ds.CONT_DEFAULT,
                         impl: str | None = None):
    """K word-frame roundtrips in ONE executable (lax.scan over the
    leading axis of xws [K, 128, NTP]) -> (totals [K], oks [K])."""
    def body(carry, xw):
        _rxw, total, ok = roundtrip_words(
            xw, qt_y, qt_u, qt_v, h=h, w=w, cont=cont, impl=impl)
        return carry, (total, ok)

    _, (totals, oks) = jax.lax.scan(body, jnp.int32(0), xws)
    return totals, oks
