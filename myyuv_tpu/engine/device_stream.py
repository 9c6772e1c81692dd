"""Fully on-device codec streams: transform + entropy on the device.

Pixels go up once, compressed bytes come down — nothing else crosses the
host<->device link:

  compress:   plane u8 --h2d--> [pack] -> [fused DCT+quant+Huffman
              encode] -> (A, C, sizes); host pulls [compact] --d2h-->
  decompress: (sizes, A, C) --h2d--> [fused Huffman decode +
              dequant+IDCT] -> [unpack] -> plane u8 (stays on device
              for metrics, or one d2h for file output)

The ragged<->dense conversions are the device analogs of
DCTYUVPlane::getContentPos (DCT.cpp:21-33). The frame/batch paths use
the DENSE TWO-REGION interchange: region A [64, ceil8(N)] holds every
chunk's first 32 bytes and region C [cont*8, ceil8(N)] its continuation
words, BOTH in the packed window layout (row 8w + r = word w of block
8c + r) and both direct outputs of the encode kernel (kernels/codec) —
so compress has no compaction gather and decompress no scatter at all.
The ragged<->dense index work survives only at the HOST boundary:
``_compact_split`` gathers the live continuation rows before a pull
(the d2h transfer must not carry the dense C), and expansion back to
dense C happens in numpy before an upload. ``cont`` (8, 16, 24 or 56
words) is the static emission tier: chunks beyond 4*(8+cont) bytes flip
ok and callers retry roomier or fall back to the host path
(engine.pipeline with native entropy).

Geometries whose planes split into whole lane columns (the packed
route) run the fused codec kernels; the rest take the plain-JAX route
(kernels/device transforms + entropy/device lockstep coder) to the same
interchange.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels import codec
from ..kernels import device as kdev
from ..kernels import words
from ..runtime.errors import BitstreamError

# interchange granularity: the host-pull compaction moves chunks in
# 8-word (32-byte) rows
ALIGN_W = 8
# DENSE TWO-REGION interchange (frame/batch paths): region A holds
# every chunk's first 32 bytes and region C its continuation words,
# both [*, ceil8(N)] in the packed window layout (row 8w + r = word w
# of block 8c + r) that the encode kernel emits and the decode kernel
# consumes verbatim. ``cont`` is the encoder's static continuation-word
# tier: 8 (64-byte chunks, covers natural content through ~q70), 16
# (96 B, q90-class), 24 (128 B — covers q100 on natural content) or 56
# (the 255-byte format maximum).
CONT_DEFAULT = 8
CONT_Q90 = 16
CONT_MID = 24
CONT_ROOMY = 56
CONT_LADDER = (CONT_DEFAULT, CONT_Q90, CONT_MID, CONT_ROOMY)
# quality at or above which streams are expected to exceed the 64-byte
# default tier (golden 4K: max chunk 58 B at q70, 71 B at q90) — callers
# that know the quality start the ladder higher (cont_for_quality)
QUALITY_MID_TIER = 85
# q95+ content can exceed the 96-byte q90 tier (q100 golden max chunk
# 118 B -> the 128-byte CONT_MID tier)
QUALITY_TOP_TIER = 95


def cont_for_quality(qmax: int):
    """Ladder start tier for a known max plane quality (None = default).

    96-byte chunks (cont=16, window cw=24) cover golden q90's 71-byte
    max with a smaller interchange than CONT_MID; overflow still retries
    up the ladder, so the hint only affects speed, never correctness."""
    if qmax >= QUALITY_TOP_TIER:
        return CONT_MID
    if qmax >= QUALITY_MID_TIER:
        return CONT_Q90
    return None

# HOST-PULL compaction of region C (the d2h transfer must not carry the
# dense C): live continuation rows gathered back to back in block
# order, budgeted by a global average in eighth-rows per block
# (capacity rows = npad * capb8_pb / 8). The row->block map costs one
# nseg-index scatter (segment-start marks -> cumsum) plus a 64-wide
# in-segment searchsorted — no N-index scatter anywhere (an
# ``.at[offs].max`` over all N blocks is the costly alternative).
SEG = 64                        # blocks per map segment
CAPB8_DEFAULT = 1               # 4 B/block avg (golden q50 uses ~10%)
CAPB8_MID = 8                   # 32 B/block avg (covers q90-class)
CAPB8_ROOMY = 56                # 224 B/block: every legal stream
CAPB8_LADDER = (CAPB8_DEFAULT, CAPB8_MID, CAPB8_ROOMY)


def capb_total(npad: int, capb8_pb: int = CAPB8_DEFAULT) -> int:
    """B-region capacity in 8-word (32-byte) rows for npad blocks."""
    return max(npad * capb8_pb // 8, 1)


# ---------------------------------------------------------------------------
# Frame-level API: one jit per geometry (all planes' blocks in one tensor)
# ---------------------------------------------------------------------------
#
# The whole frame — luma + both chroma planes — runs as one block tensor
# with a per-block quantization table selected from the three plane
# tables, so two executables cover the full codec. Block order: Y raster
# blocks, then U, then V — matching the per-plane stream split of the
# on-disk DCTYUV payload (DCT.cpp:112-173).


def _fwd_transform(blocks_flat, qt, precision: str):
    """[n, 64] u8 block rows + one [8, 8] qtable -> [n, 64] i16 (per-plane
    calls keep the quantization table a broadcast)."""
    n = blocks_flat.shape[0]
    return kdev.dct_quantize(blocks_flat.reshape(n, 8, 8), qt,
                             precision=precision).reshape(n, 64)


def _inv_transform(coeffs_flat, qt, precision: str):
    """[n, 64] i16 coefficient rows + one [8, 8] qtable -> [n, 64] u8."""
    n = coeffs_flat.shape[0]
    return kdev.unfuse(kdev.dequantize_idct(
        coeffs_flat.reshape(n, 8, 8), qt,
        precision=precision)).reshape(n, 64)


def _use_packed(precision: str, h: int, w: int) -> bool:
    """Trace-time gate for the word-packed route (the fused codec
    kernels): exact precision and a geometry whose planes split into
    whole lane columns (divisible by 16 => word-aligned rows; block
    counts divisible by 8 => plane-pure columns)."""
    return (precision == "exact" and h % 16 == 0 and w % 16 == 0
            and (h // 8) * (w // 8) % 8 == 0
            and (h // 16) * (w // 16) % 8 == 0)


def _compress_words_packed(y, u, v, qt_y, qt_u, qt_v, b: int, h: int,
                           w: int, cont: int):
    """Word-packed compress: pixel quad words -> the fused DCT + quantize
    + Huffman-encode kernel, whose outputs ARE the interchange.

    PLANE-MAJOR block order across the batch ([all Y | all U | all V],
    frames contiguous within each plane region): each plane stack packs
    as one tall plane, and U and V share one row-stacked packing."""
    ny = (h // 8) * (w // 8)
    nc = (h // 16) * (w // 16)
    n = b * (ny + 2 * nc)
    uv = jnp.concatenate([u.reshape(b * (h // 2), w // 2),
                          v.reshape(b * (h // 2), w // 2)], axis=0)
    xw = jnp.concatenate([words.pack_pixel_words(y.reshape(b * h, w)),
                          words.pack_pixel_words(uv)], axis=1)
    padc = (-(n // 8)) % codec.COLS
    if padc:
        xw = jnp.concatenate(
            [xw, jnp.zeros((128, padc), jnp.int32)], axis=1)
    A, C, sizes, ok = codec.encode(
        xw, words.stack_qtables(qt_y, qt_u, qt_v),
        words.plane_pids(b * ny, b * nc, padc), cont)
    sizes = sizes[:n]
    return A, C, sizes, jnp.sum(sizes), jnp.all(ok[:n])


def _dense_from_words(wd, sizes, ok, cont: int):
    """Plain-route dense interchange: stream-space words [N, 64]
    block-major -> (A [64, ceil8(N)], C [cont*8, ceil8(N)], sizes, total,
    ok) — the same contract the encode kernel emits."""
    n = sizes.shape[0]
    contentA = _a_to_packed(wd[:, :8].T)
    cwords = wd[:, 8:8 + cont]
    pad = (-n) % 8
    if pad:
        cwords = jnp.concatenate(
            [cwords, jnp.zeros((pad, cont), jnp.int32)], axis=0)
    C = words.pack_rows8(cwords)
    sizes = sizes.astype(jnp.int32)
    ok = ok & jnp.all(sizes <= 4 * (8 + cont))
    return contentA, C, sizes, jnp.sum(sizes), ok


@functools.partial(jax.jit, static_argnames=("precision", "cont"))
def compress_frame(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
                   qt_y: jnp.ndarray, qt_u: jnp.ndarray, qt_v: jnp.ndarray,
                   precision: str = "exact",
                   cont: int = CONT_DEFAULT):
    """Full-frame on-chip compress -> (contentA, contentC, sizes, total,
    ok): the DENSE two-region device interchange.

    ``contentA`` [64, ceil8(N)] i32 holds every chunk's first 32 bytes
    and ``contentC`` [cont*8, ceil8(N)] its continuation words, both in
    the packed window layout (bytes bit-reversed, packed big-endian —
    the codec kernels' stream space) and both direct outputs of the
    encode kernel: compress does no index work after the kernel and
    decompress consumes the pair verbatim. Chunks larger than 4*(8+cont) bytes flip ok (callers
    retry with cont=CONT_ROOMY). ``total`` is the exact byte total; the
    on-disk stream is one compaction gather + linear host pass away
    (native.repack_split). Blocks ordered Y, U, V.
    """
    h, w = y.shape
    if _use_packed(precision, h, w):
        return _compress_words_packed(y, u, v, qt_y, qt_u, qt_v,
                                      1, h, w, cont)
    by = kdev.plane_to_blocks(y)
    bu = kdev.plane_to_blocks(u)
    bv = kdev.plane_to_blocks(v)
    ny, nc = by.shape[0], bu.shape[0]
    coeffs = jnp.concatenate([
        _fwd_transform(by.reshape(ny, 64), qt_y, precision),
        _fwd_transform(bu.reshape(nc, 64), qt_u, precision),
        _fwd_transform(bv.reshape(nc, 64), qt_v, precision)])
    wd, sizes, ok = codec.entropy_encode_xla(coeffs)
    return _dense_from_words(wd, sizes, jnp.all(ok), cont)


def _chunk_rows(sizes):
    """16-byte rows each chunk occupies in the aligned interchange."""
    return (sizes + 4 * ALIGN_W - 1) // (4 * ALIGN_W)


def _b_maps(sizes_r, npad: int, capb: int):
    """Global stream-compaction maps for the B region: per-block
    CONTINUATION row counts (rows beyond the one held in A) fed to the
    generic ``_row_maps``."""
    n = sizes_r.shape[0]
    ovf = jnp.maximum(sizes_r.astype(jnp.int32) - 1, 0)
    if npad != n:
        ovf = jnp.concatenate([ovf, jnp.zeros(npad - n, jnp.int32)])
    return _row_maps(ovf, npad, capb)


def _row_maps(rows, npad: int, capb: int):
    """Generic global stream-compaction maps.

    For each compacted stream row p (stream order, capacity ``capb``
    rows) returns (src_block [capb] — the owning block id in [0, npad),
    r0 [capb] — its 0-based row index within the block, total — the
    live row count). ``rows`` [npad] i32 is the per-block row count.
    Rows p >= total carry garbage ids (callers clamp/drop).

    Scatter/gather economics: one nseg-index scatter (segment start
    marks -> cumsum -> per-row segment), one capb-element gather of the
    segment offsets, one capb-row gather of the per-segment inclusive
    row cumsums, then a 64-wide searchsorted per row — every cost is
    O(capb + nseg), never O(N)."""
    nseg = npad // SEG
    cumS = jnp.cumsum(rows.reshape(nseg, SEG), axis=1)  # [nseg, SEG] incl
    seg_tot = cumS[:, -1]
    soffs = jnp.cumsum(seg_tot) - seg_tot               # [nseg] exclusive
    total = soffs[-1] + seg_tot[-1]
    # owning segment per row: start marks (duplicates at empty segments
    # are fine — add accumulates, cumsum-1 lands on the owner)
    mark = jnp.zeros((capb,), jnp.int32).at[soffs].add(
        1, mode="drop", indices_are_sorted=True)
    seg_of = jnp.cumsum(mark) - 1                       # [capb]
    q = jnp.arange(capb, dtype=jnp.int32) - soffs[seg_of]
    cum_rows = cumS[seg_of]                             # [capb, SEG]
    qc = q[:, None]
    blockin = jnp.sum((cum_rows <= qc).astype(jnp.int32), axis=1)
    iota64 = jnp.arange(SEG, dtype=jnp.int32)[None, :]
    off_own = jnp.sum(
        jnp.where(iota64 == blockin[:, None] - 1, cum_rows, 0), axis=1)
    return seg_of * SEG + blockin, q - off_own, total


def _a_to_packed(aT):
    """Flat A region [8, n] word-major -> packed-8 [64, ceil8(n)] (the
    decoder's W0 window layout: row 8w + r = word w of block 8c + r).
    Pad blocks carry the minimal valid all-zero-block chunk."""
    n = aT.shape[1]
    pad = (-n) % 8
    if pad:
        fill = jnp.zeros((8, pad), jnp.int32).at[0].set(words.FILLER_W0)
        aT = jnp.concatenate([aT, fill], axis=1)
    n8 = aT.shape[1] // 8
    return aT.reshape(8, n8, 8).transpose(0, 2, 1).reshape(64, n8)


def _compact_split(wordsC, A, sizes, ok, capb8_pb: int = CAPB8_DEFAULT):
    """(wordsC [>=N, cont] block-major continuation words, A region) ->
    (contentA [64, ceil8(N)] packed-8, contentB [capb*8] i32
    stream-compacted, sizes, total bytes, ok).

    ``A`` arrives either packed-8 [64, *] (the encoders emit the
    decoder's W0 layout directly — pass-through) or word-major [8, N]
    (one relayout). B gathers the live
    continuation rows back to back in block order — ~capb indices, and
    capb hugs the global average instead of a per-segment worst case.
    ``cont`` (8 or 56 words) is the encoder's emission tier; chunks
    beyond it were already flagged in ok. ``wordsC`` may carry trailing
    pad-block rows (the packed frame's column padding) — never
    gathered."""
    sizes = sizes.astype(jnp.int32)
    sizes_r = _chunk_rows(sizes)
    total = jnp.sum(sizes)
    crows = wordsC.shape[1] // ALIGN_W
    contentA = A if A.shape[0] == 64 else _a_to_packed(A)
    # the padded block count derives from the A width on BOTH
    # interchange sides, so contentA crosses without any copy
    npad = -(-contentA.shape[1] * 8 // SEG) * SEG
    capb = capb_total(npad, capb8_pb)
    src_block, r0, totb = _b_maps(sizes_r, npad, capb)
    gsrc = jnp.clip(src_block, 0, npad - 1) * crows \
        + jnp.clip(r0, 0, crows - 1)
    rows = wordsC.reshape(-1, ALIGN_W)
    B = rows[jnp.clip(gsrc, 0, rows.shape[0] - 1)]
    return (contentA, B.reshape(-1), sizes, total, ok & (totb <= capb))


def _decode_idct_packed(W0, Wc, qt_y, qt_u, qt_v, ny: int, nc: int,
                        b: int, h: int, w: int):
    """Packed window words -> (y, u, v, ok[n]) via the fused Huffman
    decode + dequantize + IDCT kernel, which emits pixel QUAD WORDS
    [128, NP]; the only relayout of the decompress is the final
    word->plane move. PLANE-MAJOR block order ([all Y | all U | all V],
    frames contiguous within each region). Requires ny, nc divisible
    by 8."""
    n = b * (ny + 2 * nc)
    by8 = b * ny // 8
    bc8 = b * nc // 8
    pixw, ok = codec.decode(
        W0, Wc, words.stack_qtables(qt_y, qt_u, qt_v),
        words.plane_pids(b * ny, b * nc, W0.shape[1] - n // 8))
    y = words.unpack_pixel_words(pixw[:, :by8], b * h, w)
    # U and V unpack as one row-stacked plane (mirror of the pack side)
    uvp = words.unpack_pixel_words(pixw[:, by8:by8 + 2 * bc8],
                                   2 * b * (h // 2), w // 2)
    u = uvp[:b * (h // 2)]
    v = uvp[b * (h // 2):]
    if b > 1:
        y = y.reshape(b, h, w)
        u = u.reshape(b, h // 2, w // 2)
        v = v.reshape(b, h // 2, w // 2)
    return y, u, v, ok[:n]


def _decode_windows_xla(W0, Wc, n: int):
    """Two-region packed windows (W0 [64, NP], Wc [(cw-8)*8, NP]) ->
    ([n, 64] i16, [n] ok) through the plain-JAX lockstep decoder."""
    coeffs, ok = codec.entropy_decode_xla(W0, Wc)
    return coeffs[:n], ok[:n]


@functools.partial(jax.jit, static_argnames=("h", "w", "precision"))
def decompress_frame(contentA: jnp.ndarray, contentC: jnp.ndarray,
                     sizes: jnp.ndarray,
                     qt_y: jnp.ndarray, qt_u: jnp.ndarray,
                     qt_v: jnp.ndarray, h: int, w: int,
                     precision: str = "exact"):
    """Full-frame on-chip decompress of the dense two-region interchange
    -> (y, u, v, ok).

    (contentA, contentC) ARE the decode kernels' (W0, Wc) window regions
    — no expansion stage at all. The window capacity cw = 8 +
    contentC rows / 8 words per block; chunks beyond it flip ok False
    (the encoder already flagged them at compress time).
    """
    ny = (h // 8) * (w // 8)
    nc = (h // 16) * (w // 16)
    sizes = sizes.astype(jnp.int32)
    sizes_r = _chunk_rows(sizes)
    cw = 8 + contentC.shape[0] // 8
    W0, Wc = contentA, contentC
    if precision == "exact" and ny % 8 == 0 and nc % 8 == 0:
        y, u, v, ok = _decode_idct_packed(
            W0, Wc, qt_y, qt_u, qt_v, ny, nc, 1, h, w)
        return y, u, v, jnp.all(ok & (sizes_r <= cw // ALIGN_W))
    coeffs, ok = _decode_windows_xla(W0, Wc, ny + 2 * nc)
    ok = ok & (sizes_r <= cw // ALIGN_W)
    py = _inv_transform(coeffs[:ny], qt_y, precision)
    pu = _inv_transform(coeffs[ny:ny + nc], qt_u, precision)
    pv = _inv_transform(coeffs[ny + nc:], qt_v, precision)
    y = kdev.blocks_to_plane(py.reshape(ny, 8, 8), h, w)
    u = kdev.blocks_to_plane(pu.reshape(nc, 8, 8), h // 2, w // 2)
    v = kdev.blocks_to_plane(pv.reshape(nc, 8, 8), h // 2, w // 2)
    return y, u, v, jnp.all(ok)


# ---------------------------------------------------------------------------
# Batched multi-frame API: B frames per executable
# ---------------------------------------------------------------------------
#
# The reference's throughput story is one image at a time (myyuv_cli); the
# device story is a batch axis: B frames' blocks concatenate into one
# block tensor so dispatch, layout changes and kernel launches amortize
# across the batch.
# Block order is PLANE-MAJOR across the batch ([all Y | all U | all V],
# frames contiguous within each plane region): each plane stack packs as
# one tall plane with zero per-frame slicing; batch_streams_split maps
# (frame, plane) segments with plain index arithmetic.


@functools.partial(jax.jit, static_argnames=("precision", "cont"))
def compress_batch(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
                   qt_y: jnp.ndarray, qt_u: jnp.ndarray, qt_v: jnp.ndarray,
                   precision: str = "exact",
                   cont: int = CONT_DEFAULT):
    """[B, H, W] (+2x [B, H/2, W/2]) u8 -> (contentA, contentC, sizes
    [B*Nf], total bytes, ok) — the whole batch compressed on the device
    in one executable (dense two-region interchange)."""
    b, h, w = y.shape
    if _use_packed(precision, h, w):
        return _compress_words_packed(y, u, v, qt_y, qt_u, qt_v,
                                      b, h, w, cont)
    by = kdev.plane_to_blocks(y)                 # [B, ny, 8, 8]
    bu = kdev.plane_to_blocks(u)
    bv = kdev.plane_to_blocks(v)
    ny, nc = by.shape[1], bu.shape[1]
    cy = _fwd_transform(by.reshape(b * ny, 64), qt_y, precision)
    cu = _fwd_transform(bu.reshape(b * nc, 64), qt_u, precision)
    cv = _fwd_transform(bv.reshape(b * nc, 64), qt_v, precision)
    # plane-major block order, matching the packed route
    coeffs = jnp.concatenate([cy, cu, cv])
    wd, sizes, ok = codec.entropy_encode_xla(coeffs)
    return _dense_from_words(wd, sizes, jnp.all(ok), cont)


@functools.partial(jax.jit,
                   static_argnames=("b", "h", "w", "precision"))
def decompress_batch(contentA: jnp.ndarray, contentC: jnp.ndarray,
                     sizes: jnp.ndarray,
                     qt_y: jnp.ndarray, qt_u: jnp.ndarray,
                     qt_v: jnp.ndarray, b: int, h: int, w: int,
                     precision: str = "exact"):
    """Batch dense interchange -> ([B, H, W], 2x [B, H/2, W/2], ok)."""
    ny = (h // 8) * (w // 8)
    nc = (h // 16) * (w // 16)
    sizes = sizes.astype(jnp.int32)
    sizes_r = _chunk_rows(sizes)
    cw = 8 + contentC.shape[0] // 8
    W0, Wc = contentA, contentC
    if precision == "exact" and ny % 8 == 0 and nc % 8 == 0:
        y, u, v, ok = _decode_idct_packed(
            W0, Wc, qt_y, qt_u, qt_v, ny, nc, b, h, w)
        return y, u, v, jnp.all(ok & (sizes_r <= cw // ALIGN_W))
    coeffs, ok = _decode_windows_xla(W0, Wc, b * (ny + 2 * nc))
    ok = ok & (sizes_r <= cw // ALIGN_W)
    # plane-major block order, matching the packed route
    py = _inv_transform(coeffs[:b * ny], qt_y, precision)
    pu = _inv_transform(coeffs[b * ny:b * (ny + nc)], qt_u, precision)
    pv = _inv_transform(coeffs[b * (ny + nc):], qt_v, precision)
    y = kdev.blocks_to_plane(py.reshape(b, ny, 8, 8), h, w)
    u = kdev.blocks_to_plane(pu.reshape(b, nc, 8, 8), h // 2, w // 2)
    v = kdev.blocks_to_plane(pv.reshape(b, nc, 8, 8), h // 2, w // 2)
    return y, u, v, jnp.all(ok)


@functools.partial(jax.jit, static_argnames=("precision", "cont"))
def roundtrip_frame(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
                    qt_y: jnp.ndarray, qt_u: jnp.ndarray,
                    qt_v: jnp.ndarray, precision: str = "exact",
                    cont: int = CONT_DEFAULT):
    """Whole compress+decompress roundtrip as ONE executable ->
    (ry, ru, rv, total bytes, ok) — the transcode/RD-loop entry
    (quality evaluation runs exactly this shape), and one device
    dispatch instead of two."""
    h, w = y.shape
    cA, cC, sizes, total, ok = compress_frame(
        y, u, v, qt_y, qt_u, qt_v, precision=precision, cont=cont)
    ry, ru, rv, dok = decompress_frame(
        cA, cC, sizes, qt_y, qt_u, qt_v, h=h, w=w, precision=precision)
    return ry, ru, rv, total, ok & dok


@functools.partial(jax.jit, static_argnames=("precision", "cont"))
def roundtrip_scan(ys, us, vs, qt_y, qt_u, qt_v,
                   precision: str = "exact", cont: int = CONT_DEFAULT):
    """K whole-frame roundtrips in ONE executable via ``lax.scan`` over
    stacked frames ([K, H, W] / [K, H/2, W/2] x2) -> (totals [K] i64,
    ok [K] bool).

    Each scan iteration runs the SAME frame-geometry codec body (no
    cross-frame padding), so K frames cost one host dispatch; recon
    planes stay in the loop body (transcode/RD semantics, like
    streaming.roundtrip_stream)."""
    def body(carry, fr):
        y, u, v = fr
        _ry, _ru, _rv, total, ok = roundtrip_frame(
            y, u, v, qt_y, qt_u, qt_v, precision=precision, cont=cont)
        return carry, (total, ok)

    _, (totals, oks) = jax.lax.scan(body, jnp.int32(0), (ys, us, vs))
    return totals, oks


def roundtrip_batch(y, u, v, qtables, precision: str = "exact"):
    """On-chip roundtrip of a [B, ...] frame batch; returns device arrays
    (recon planes, total compressed bytes, ok)."""
    b, h, w = y.shape
    cA, cB, sizes, total, ok = compress_batch(
        y, u, v, *qtables, precision=precision)
    ry, ru, rv, dok = decompress_batch(
        cA, cB, sizes, *qtables, b=b, h=h, w=w, precision=precision)
    return (ry, ru, rv), total, ok & dok


def batch_streams_split(sizes_np: np.ndarray, packed: np.ndarray,
                        b: int, ny: int, nc: int):
    """Split a batch's packed bytes into per-frame [(sizes, content) x3].

    Batch block order is PLANE-MAJOR ([all Y | all U | all V], frames
    contiguous within each plane region)."""
    boffs = np.cumsum(sizes_np.astype(np.int64)) - sizes_np
    frames = [[] for _ in range(b)]
    pbase = 0
    for npl in (ny, nc, nc):
        for f in range(b):
            lo = pbase + f * npl
            s = sizes_np[lo:lo + npl]
            base = int(boffs[lo])
            frames[f].append(
                (s.astype(np.uint8),
                 packed[base:base + int(s.astype(np.int64).sum())]))
        pbase += b * npl
    return frames


@functools.partial(jax.jit, static_argnames=("capb8_pb",))
def _compact_c(contentA, contentC, sizes, capb8_pb: int):
    """Gather region C's live continuation rows before a host pull ->
    (contentB [capb*8] i32, ok) — the compacted artifact-side B region,
    what native.repack_split consumes. Runs only on the host-facing
    stream APIs — the pure device roundtrip never compacts. ``ok`` is
    the device-side capacity check; callers assert it so a divergence
    between _capb_tier's host arithmetic and _b_maps can never silently
    truncate the pulled stream."""
    c_bm = words.unpack_rows8(contentC)
    _, cB, _, _, ok = _compact_split(c_bm, contentA, sizes,
                                     jnp.bool_(True), capb8_pb)
    return cB, ok


# PULL-LEAN stream compaction tiers for the streaming driver
# (engine/streaming.py): average words per block * 8. The dense A+C
# regions carry ~3x the live bytes and the d2h pull is the streaming
# budget, so the device gathers the exact live words (4-byte
# granularity) before the transfer. 32 = 16 B/block avg
# (golden q50 needs ~13.7), 96 = 48 B (q90-class), 512 = the 255-byte
# format maximum.
CAPW8_DEFAULT = 32
CAPW8_MID = 96
CAPW8_ROOMY = 512
CAPW8_LADDER = (CAPW8_DEFAULT, CAPW8_MID, CAPW8_ROOMY)


@functools.partial(jax.jit, static_argnames=("capw8",))
def _compact_stream_words(contentA, contentC, sizes, ok, capw8: int):
    """Dense two-region interchange -> (words [capw] i32 — the EXACT
    live stream words back to back in block order, each chunk padded to
    a word boundary; sizes_u8 [N]; ok) for a pull-lean d2h transfer.

    The host finishes with native.repack_words(words[:totw], sizes,
    align=1) — a linear byte squeeze. The gather is O(capw) element
    indices via the same segment machinery as the B-region compaction
    (_row_maps); capw = npad * capw8 // 8."""
    sizes = sizes.astype(jnp.int32)
    n = sizes.shape[0]
    n8 = contentA.shape[1]
    npad = -(-n8 * 8 // SEG) * SEG
    capw = max(npad * capw8 // 8, 1)
    rows = (sizes + 3) // 4                  # words per chunk
    if npad != n:
        rows = jnp.concatenate([rows, jnp.zeros(npad - n, jnp.int32)])
    src_block, r0, totw = _row_maps(rows, npad, capw)
    W = jnp.concatenate([contentA, contentC], axis=0)   # [cw*8, n8]
    cw = W.shape[0] // 8
    b = jnp.clip(src_block, 0, n8 * 8 - 1)
    w = jnp.clip(r0, 0, cw - 1)
    words = W[8 * w + b % 8, b // 8]
    return (words, sizes.astype(jnp.uint8),
            ok & (totw <= capw) & jnp.all(sizes <= 4 * cw))


def _capb_tier(sizes_np: np.ndarray, ntp: int) -> int:
    """Smallest pull-compaction tier covering the stream's live
    continuation rows — picked from HOST-VISIBLE stats, so the pull
    never ladder-walks (cannot fail for format-legal <=255 B chunks)."""
    sizes_r = (sizes_np.astype(np.int64) + 4 * ALIGN_W - 1) \
        // (4 * ALIGN_W)
    totb = int(np.maximum(sizes_r - 1, 0).sum())
    npad = -(-ntp * 8 // SEG) * SEG
    for t in CAPB8_LADDER:
        if totb <= capb_total(npad, t):
            return t
    raise BitstreamError("stream larger than device capacity")


def _pull_packed_stream(cA, cC, sizes, sizes_np: np.ndarray) -> np.ndarray:
    """(device interchange, host sizes) -> exact packed byte stream."""
    from .. import native
    tier = _capb_tier(sizes_np, cA.shape[1])
    cB, ok = _compact_c(cA, cC, sizes, tier)
    if not bool(ok):
        raise BitstreamError("pull compaction overflowed its tier")
    aT_np, b_np = pull_split(cA, cB)
    return native.repack_split(aT_np, b_np, sizes_np)


def compress_batch_to_streams(planes_np, qtables_np,
                              precision: str = "exact"):
    """Host API: batched planes -> per-frame stream lists (file layout)."""
    y, u, v = [np.ascontiguousarray(p) for p in planes_np]
    b, h, w = y.shape
    ny = (h // 8) * (w // 8)
    nc = (h // 16) * (w // 16)
    cA = cC = sizes = None
    for cont in CONT_LADDER:
        cA, cC, sizes, total, ok = compress_batch(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
            *[jnp.asarray(q) for q in qtables_np], precision=precision,
            cont=cont)
        if bool(ok):
            break
    else:
        raise BitstreamError("device compress overflow/failure")
    sizes_np = np.asarray(sizes).astype(np.int32)
    packed = _pull_packed_stream(cA, cC, sizes, sizes_np)
    return batch_streams_split(sizes_np, packed, b, ny, nc)


# ---------------------------------------------------------------------------
# Host-facing helpers (pull/push with bounded shape variants)
# ---------------------------------------------------------------------------


def pull_split(contentA_dev: jnp.ndarray, contentB_dev: jnp.ndarray):
    """Pull the split-stream artifact -> (a i32 [64, ceil8(N)] packed-8
    W0 layout, b i32 [nseg*slots, 8] segment-padded)."""
    a = np.asarray(contentA_dev)
    b = np.asarray(contentB_dev).reshape(-1, ALIGN_W)
    return a, b


def _split_planes(sizes_np, packed, ny, nc):
    out = []
    pos = 0
    for lo, hi in ((0, ny), (ny, ny + nc), (ny + nc, ny + 2 * nc)):
        s = sizes_np[lo:hi]
        t = int(s.astype(np.int64).sum())
        out.append((s.astype(np.uint8), packed[pos: pos + t]))
        pos += t
    return out


def compress_frame_to_streams(planes_np, qtables_np,
                              precision: str = "exact",
                              cont0: int | None = None,
                              stats: dict | None = None):
    """Host API: (y, u, v) planes -> [(sizes u8, content u8)] per plane.

    Compacts region C's live continuation rows on device, pulls
    (A + live B rows) and repacks to the exact on-disk layout in one
    native pass. ``cont0`` pre-picks the emission tier (callers that
    know the quality pass CONT_MID for q >= QUALITY_MID_TIER, skipping
    the default-tier attempt and its compile). ``stats``, if given,
    receives the tier that succeeded under "cont"."""
    h, w = planes_np[0].shape
    ny = (h // 8) * (w // 8)
    nc = (h // 16) * (w // 16)
    ladder = CONT_LADDER if cont0 is None else tuple(
        t for t in CONT_LADDER if t >= cont0)
    cA = cC = sizes = None
    for cont in ladder:
        cA, cC, sizes, total, ok = compress_frame(
            jnp.asarray(planes_np[0]), jnp.asarray(planes_np[1]),
            jnp.asarray(planes_np[2]),
            *[jnp.asarray(q) for q in qtables_np],
            precision=precision, cont=cont)
        if bool(ok):
            break
    else:
        raise BitstreamError("device compress overflow/failure")
    if stats is not None:
        stats["cont"] = cont
    sizes_np = np.asarray(sizes).astype(np.int32)
    packed = _pull_packed_stream(cA, cC, sizes, sizes_np)
    return _split_planes(sizes_np, packed, ny, nc)


def _dense_c_np(b_np: np.ndarray, sizes_np: np.ndarray,
                cont: int) -> np.ndarray:
    """Compacted live continuation rows -> dense region C
    [cont*8, ceil8(N)] (the decoder's Wc window layout) in numpy — the
    upload direction of the host boundary (expansion happens on the
    host, before the transfer)."""
    n = sizes_np.size
    n8 = (n + 7) // 8
    sizes_r = (sizes_np.astype(np.int64) + 4 * ALIGN_W - 1) \
        // (4 * ALIGN_W)
    nbr = np.maximum(sizes_r - 1, 0)
    totb = int(nbr.sum())
    c_bm = np.zeros((n8 * 8, cont), np.int32)
    if totb:
        rows = np.ascontiguousarray(b_np).reshape(-1, ALIGN_W)[:totb]
        src = np.repeat(np.arange(n), nbr)
        boffs = np.cumsum(nbr) - nbr
        r0 = (np.arange(totb) - boffs[src]).astype(np.int64)
        for j in range(int(r0.max()) + 1):
            m = r0 == j
            c_bm[src[m], ALIGN_W * j:ALIGN_W * (j + 1)] = rows[m]
    return np.ascontiguousarray(
        c_bm.T.reshape(cont, n8, 8).transpose(0, 2, 1).reshape(
            cont * 8, n8))


def decompress_streams_to_frame(streams, qtables_np, h: int, w: int,
                                precision: str = "exact"):
    """Host API: per-plane (sizes, content) -> (y, u, v) uint8 planes."""
    from .. import native
    sizes_np = np.concatenate([s.astype(np.int32) for s, _ in streams])
    content_np = np.concatenate([c for _, c in streams])
    maxsz = int(sizes_np.max(initial=0))
    cont = next(t for t in CONT_LADDER if maxsz <= 4 * (8 + t))
    aT_np, b_np = native.expand_split(content_np, sizes_np)
    c_np = _dense_c_np(b_np, sizes_np, cont)
    y, u, v, ok = decompress_frame(
        jnp.asarray(aT_np), jnp.asarray(c_np), jnp.asarray(sizes_np),
        *[jnp.asarray(q) for q in qtables_np], h=h, w=w,
        precision=precision)
    if not bool(ok):
        raise BitstreamError("Huffman bad code (device decode)")
    return np.asarray(y), np.asarray(u), np.asarray(v)
