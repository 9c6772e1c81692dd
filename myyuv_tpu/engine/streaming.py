"""K-frames-in-flight streaming drivers.

The reference's throughput story is the OpenMP pipeline keeping all
cores busy (DCT.cpp:399-426); the device story is keeping the card busy
across FRAMES: executes pipeline through the runtime as long as nothing
synchronizes, so the driver never syncs inside the steady state.

* d2h pulls OVERLAP with executes via ``copy_to_host_async`` — the
  compress driver pulls the pull-lean compacted stream (exact live
  words, far smaller than the dense interchange) while later frames
  compress;
* host-side assembly (native byte squeeze) also overlaps device work.

``roundtrip_stream`` is the transcode/RD engine loop: frames stay on
device, per-frame ok/total flags are stacked in fixed-size chunks on
device and pulled only at the drain, so the execute pipeline never
stalls. ``compress_stream`` is the capture loop: per-frame compressed
bytes come down the link with bounded in-flight depth.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Iterable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels import device as kdev
from ..runtime.errors import BitstreamError
from . import device_stream as ds

# ok/total flags are stacked on device in fixed-arity chunks: one tiny
# executable per arity (reused), one d2h pull per chunk at the drain
FLAG_CHUNK = 16


@jax.jit
def _stack_flags(*xs):
    return jnp.stack(xs)


def _stack_chunks(flags) -> List[jnp.ndarray]:
    """List of device scalars -> list of stacked chunk arrays (device)."""
    out = []
    for i in range(0, len(flags), FLAG_CHUNK):
        out.append(_stack_flags(*flags[i:i + FLAG_CHUNK]))
    return out


def roundtrip_stream(frames: Sequence[Tuple], qtables,
                     precision: str = "exact",
                     cont: int = ds.CONT_DEFAULT):
    """Async-chain roundtrips over device-resident frames.

    ``frames``: sequence of (y, u, v) DEVICE arrays. Returns
    (ok [N] bool, totals [N] int64, elapsed_s). Dispatches every
    frame's fused roundtrip executable back to back with ZERO host
    syncs; the per-frame ok/total scalars are stacked into device
    chunks mid-stream and pulled once at the drain (the pull of the
    stacked chunks is the pipeline drain — each chunk depends on its
    frames' executes)."""
    oks, totals = [], []
    t0 = time.perf_counter()
    for (y, u, v) in frames:
        ry, ru, rv, total, ok = ds.roundtrip_frame(
            y, u, v, *qtables, precision=precision, cont=cont)
        oks.append(ok)
        totals.append(total)
        # ry/ru/rv refs drop here: buffers free as the pipeline advances
    okc = _stack_chunks(oks)
    totc = _stack_chunks(totals)
    for c in okc:
        c.copy_to_host_async()
    for c in totc:
        c.copy_to_host_async()
    ok_np = np.concatenate([np.asarray(c) for c in okc])
    tot_np = np.concatenate([np.asarray(c).astype(np.int64)
                             for c in totc])
    elapsed = time.perf_counter() - t0
    return ok_np, tot_np, elapsed


def sustained_roundtrip_fps(planes_np, qtables, n_frames: int = 112,
                            precision: str = "exact",
                            cont: int = ds.CONT_DEFAULT,
                            k: int = 8, windows: int = 2):
    """Upload one frame, run ``n_frames`` streamed roundtrips through
    the PRODUCTION scan-batched executable (``ds.roundtrip_scan``: k
    frames per dispatch), retry any overflowed frame up the cont ladder
    (retries timed too).

    Returns (fps, ok_all, total_bytes_frame0, stats): ``stats`` carries
    every measurement window's fps and ok count (``windows_fps``,
    ``windows_ok``) so a host hiccup or a discarded overflow in a
    non-best window stays visible in the bench JSON — the headline is
    the best window, the spread is the evidence."""
    dev = tuple(jnp.asarray(p) for p in planes_np)
    ys, us, vs = (jnp.broadcast_to(p, (k,) + p.shape) for p in dev)
    n_frames = -(-n_frames // k) * k
    n_calls = n_frames // k
    # warm run: the scan executable compiles outside the timed region
    _t0s, o0s = ds.roundtrip_scan(ys, us, vs, *qtables,
                                  precision=precision, cont=cont)
    np.asarray(o0s)

    def window():
        outs = []
        t0 = time.perf_counter()
        for _ in range(n_calls):
            totals, oks = ds.roundtrip_scan(ys, us, vs, *qtables,
                                            precision=precision,
                                            cont=cont)
            outs.append((totals, oks))
        for totals, oks in outs:
            totals.copy_to_host_async()
            oks.copy_to_host_async()
        ok_np = np.concatenate([np.asarray(o) for _, o in outs])
        elapsed = time.perf_counter() - t0
        tot0 = int(np.asarray(outs[0][0])[0])
        return ok_np, tot0, elapsed

    runs = [window() for _ in range(max(1, windows))]
    stats = {
        "windows_fps": [round(n_frames / e, 2) for _, _, e in runs],
        "windows_ok": [int(o.sum()) for o, _, _ in runs],
        "frames_per_dispatch": k,
    }
    # headline window: most frames ok, then fastest — every window is
    # reported in ``stats`` so nothing is silently dropped
    ok_np, tot0, elapsed = max(
        runs, key=lambda r: (int(r[0].sum()), -r[2]))
    n_retry = int((~ok_np).sum())
    if n_retry:
        ladder = [t for t in ds.CONT_LADDER if t > cont]
        t0 = time.perf_counter()
        for tier in ladder:
            okr, _, _ = roundtrip_stream(
                [dev] * n_retry, qtables, precision=precision, cont=tier)
            if okr.all():
                break
        else:
            return None, False, None, stats
        elapsed += time.perf_counter() - t0
        stats["retried_frames"] = n_retry
    return (n_frames / elapsed, bool(ok_np.all() or n_retry), tot0,
            stats)


_convert_fwd = jax.jit(kdev.bgrx_to_iyuv)
_convert_inv = jax.jit(kdev.iyuv_to_bgrx)


def ingest_stream(frames_bgrx: Sequence, qtables,
                  precision: str = "exact",
                  cont: int = ds.CONT_DEFAULT):
    """The CAPTURE pipeline: BGRX device frames -> colorspace convert ->
    compress, chained with zero steady-state syncs (the device
    version of the reference's capture flow: bmp_to_yuv_map lambda +
    compress_DCT_planar, myyuv_yuv.cpp:88-127 + DCT.cpp:371-430).

    Returns (ok [N] bool, totals [N] int64, elapsed_s). The compressed
    interchange tensors drop per frame (a capture deployment would hand
    them to compress_stream-style pulls; here the metric is chip
    throughput of the convert+compress chain)."""
    oks, totals = [], []
    t0 = time.perf_counter()
    for px in frames_bgrx:
        y, u, v = _convert_fwd(px)
        _cA, _cC, _sizes, total, ok = ds.compress_frame(
            y, u, v, *qtables, precision=precision, cont=cont)
        oks.append(ok)
        totals.append(total)
    okc = _stack_chunks(oks)
    totc = _stack_chunks(totals)
    for c in okc + totc:
        c.copy_to_host_async()
    ok_np = np.concatenate([np.asarray(c) for c in okc])
    tot_np = np.concatenate([np.asarray(c).astype(np.int64)
                             for c in totc])
    elapsed = time.perf_counter() - t0
    return ok_np, tot_np, elapsed


def preview_stream(stream_dev: Tuple, qtables, h: int, w: int,
                   n_frames: int, precision: str = "exact"):
    """The PLAYBACK pipeline: compressed interchange (device) ->
    decompress -> RGB preview conversion, chained with zero
    steady-state syncs (the reference analog: decompress_DCT_planar +
    the GL viewer's frag_yuv.glsl pass). Returns (ok [N], elapsed_s)."""
    cA, cC, sizes = stream_dev
    oks = []
    t0 = time.perf_counter()
    for _ in range(n_frames):
        y, u, v, ok = ds.decompress_frame(
            cA, cC, sizes, *qtables, h=h, w=w, precision=precision)
        _px = _convert_inv(y, u, v)
        oks.append(ok)
    okc = _stack_chunks(oks)
    for c in okc:
        c.copy_to_host_async()
    ok_np = np.concatenate([np.asarray(c) for c in okc])
    elapsed = time.perf_counter() - t0
    return ok_np, elapsed


def sustained_pipeline_fps(planes_np, qtables, n_frames: int = 112,
                           precision: str = "exact",
                           cont: int = ds.CONT_DEFAULT):
    """Sustained fps of the two production pipelines over the golden
    frame: ingest (BGRX -> IYUV -> compress) and preview (stream ->
    IYUV -> BGRX). The BGRX input is synthesized on device from the
    golden planes (iyuv_to_bgrx of the frame being benched), so both
    chains run real content. Returns (ingest_fps, preview_fps, ok)."""
    dev = tuple(jnp.asarray(p) for p in planes_np)
    h, w = planes_np[0].shape
    px = _convert_inv(*dev)
    n_frames = -(-n_frames // FLAG_CHUNK) * FLAG_CHUNK
    # warm both chains (compiles outside the timed regions)
    ok_w, _, _ = ingest_stream([px] * FLAG_CHUNK, qtables,
                               precision=precision, cont=cont)
    cA, cC, sizes, _tot, okc = ds.compress_frame(
        *dev, *qtables, precision=precision, cont=cont)
    ok0 = bool(np.asarray(okc)) and bool(ok_w.all())
    stream_dev = (cA, cC, sizes)
    preview_stream(stream_dev, qtables, h, w, FLAG_CHUNK,
                   precision=precision)
    ok_i, _, t_i = ingest_stream([px] * n_frames, qtables,
                                 precision=precision, cont=cont)
    ok_p, t_p = preview_stream(stream_dev, qtables, h, w, n_frames,
                               precision=precision)
    ok = ok0 and bool(ok_i.all()) and bool(ok_p.all())
    return n_frames / t_i, n_frames / t_p, ok


def sustained_word_pipeline_fps(planes_np, qtables, n_frames: int = 112,
                                cont: int = ds.CONT_DEFAULT):
    """Word-contract production pipelines: ingest = BGRX ->
    bgrx_to_frame -> compress_words; preview =
    interchange -> decompress_words -> frame_to_bgrx. Zero steady-state
    syncs, flags stacked on device. Returns
    (ingest_fps, preview_fps, ok)."""
    from . import word_frame as wf
    h, w = planes_np[0].shape
    dev = tuple(jnp.asarray(p) for p in planes_np)
    px = _convert_inv(*dev)
    n_frames = -(-n_frames // FLAG_CHUNK) * FLAG_CHUNK
    xw0 = wf.pack_frame(*dev)
    A, C, sizes, _tot, ok0 = wf.compress_words(xw0, *qtables, h=h, w=w,
                                               cont=cont)

    def ingest(nf):
        # ONE executable per frame (bgrx_to_frame + compress fused)
        oks = []
        t0 = time.perf_counter()
        for _ in range(nf):
            _A, _C, _s, _t, ok = wf.ingest_frame(
                px, *qtables, h=h, w=w, cont=cont)
            oks.append(ok)
        okc = _stack_chunks(oks)
        for c in okc:
            c.copy_to_host_async()
        ok_np = np.concatenate([np.asarray(c) for c in okc])
        return ok_np, time.perf_counter() - t0

    def preview(nf):
        # ONE executable per frame (decompress + frame_to_bgrx fused)
        oks = []
        t0 = time.perf_counter()
        for _ in range(nf):
            _px, ok = wf.preview_frame(A, C, sizes, *qtables, h=h, w=w)
            oks.append(ok)
        okc = _stack_chunks(oks)
        for c in okc:
            c.copy_to_host_async()
        ok_np = np.concatenate([np.asarray(c) for c in okc])
        return ok_np, time.perf_counter() - t0

    ingest(FLAG_CHUNK)
    preview(FLAG_CHUNK)
    ok_i, t_i = ingest(n_frames)
    ok_p, t_p = preview(n_frames)
    ok = bool(ok0) and bool(ok_i.all()) and bool(ok_p.all())
    return n_frames / t_i, n_frames / t_p, ok


def sustained_scan_fps(planes_np, qtables, n_frames: int = 112,
                       k: int = 8, precision: str = "exact",
                       cont: int = ds.CONT_DEFAULT):
    """Sustained fps of the scan-batched roundtrip executable
    (ds.roundtrip_scan: K frames per dispatch — one host dispatch for
    K frames). Returns
    (fps, ok_all, total_bytes_frame0)."""
    ys = jnp.broadcast_to(jnp.asarray(planes_np[0]),
                          (k,) + planes_np[0].shape)
    us = jnp.broadcast_to(jnp.asarray(planes_np[1]),
                          (k,) + planes_np[1].shape)
    vs = jnp.broadcast_to(jnp.asarray(planes_np[2]),
                          (k,) + planes_np[2].shape)
    n_calls = -(-n_frames // k)
    # warm (compile outside the timed region)
    t0s, o0s = ds.roundtrip_scan(ys, us, vs, *qtables,
                                 precision=precision, cont=cont)
    np.asarray(o0s)
    outs = []
    t0 = time.perf_counter()
    for _ in range(n_calls):
        totals, oks = ds.roundtrip_scan(ys, us, vs, *qtables,
                                        precision=precision, cont=cont)
        outs.append((totals, oks))
    for totals, oks in outs:
        totals.copy_to_host_async()
        oks.copy_to_host_async()
    ok_all = all(bool(np.asarray(oks).all()) for _, oks in outs)
    elapsed = time.perf_counter() - t0
    return n_calls * k / elapsed, ok_all, int(np.asarray(outs[0][0])[0])


def sustained_word_fps(planes_np, qtables, n_frames: int = 112,
                       cont: int = ds.CONT_DEFAULT, windows: int = 2):
    """Sustained roundtrips on the WORD CONTRACT (engine/word_frame):
    per-frame roundtrip_words executables chained with zero steady
    syncs, flags stacked on device and pulled at the drain. The frame
    never leaves its packed i32 layout, so each roundtrip is the two
    fused kernels and nothing else. Returns (fps, ok_all, total, stats)
    with every window reported (same contract as
    sustained_roundtrip_fps)."""
    from . import word_frame as wf
    h, w = planes_np[0].shape
    dev = tuple(jnp.asarray(p) for p in planes_np)
    xw = wf.pack_frame(*dev)
    _rxw, t0tot, ok0 = wf.roundtrip_words(xw, *qtables, h=h, w=w,
                                          cont=cont)
    np.asarray(ok0)
    n_frames = -(-n_frames // FLAG_CHUNK) * FLAG_CHUNK

    def window(nf):
        oks, totals = [], []
        t0 = time.perf_counter()
        for _ in range(nf):
            _rxw, total, ok = wf.roundtrip_words(xw, *qtables, h=h,
                                                 w=w, cont=cont)
            oks.append(ok)
            totals.append(total)
        okc = _stack_chunks(oks)
        totc = _stack_chunks(totals)
        for c in okc + totc:
            c.copy_to_host_async()
        ok_np = np.concatenate([np.asarray(c) for c in okc])
        tot0 = int(np.asarray(totc[0])[0])
        return ok_np, tot0, time.perf_counter() - t0

    # one chunk-sized warm window: the flag-stack executables compile
    # OUTSIDE the timed windows
    window(FLAG_CHUNK)
    runs = [window(n_frames) for _ in range(max(1, windows))]
    stats = {
        "windows_fps": [round(n_frames / e, 2) for _, _, e in runs],
        "windows_ok": [int(o.sum()) for o, _, _ in runs],
    }
    ok_np, tot0, elapsed = max(
        runs, key=lambda r: (int(r[0].sum()), -r[2]))
    return (n_frames / elapsed, bool(ok_np.all()) and bool(ok0), tot0,
            stats)


def _capw_tier0(qualities, cont: int) -> int:
    """Start tier for the pull compaction, from the quality/cont hint."""
    if cont > ds.CONT_DEFAULT or (
            qualities and max(qualities) >= ds.QUALITY_MID_TIER):
        return ds.CAPW8_MID
    return ds.CAPW8_DEFAULT


def compress_stream(frames: Iterable[Tuple], qtables,
                    precision: str = "exact",
                    cont: int = ds.CONT_DEFAULT,
                    capw8: Optional[int] = None,
                    qualities: Optional[Sequence[int]] = None,
                    depth: int = 3):
    """Streamed compress of device-resident frames with overlapped
    pulls: yields per-frame [(sizes u8, content u8) x 3] plane streams
    (identical bytes to compress_frame_to_streams).

    Pipeline per frame: compress_frame -> _compact_stream_words (the
    pull-lean gather) -> copy_to_host_async on (words, sizes, ok); the
    NEXT frame's executes dispatch before the oldest pending frame is
    assembled on the host, so transfers and host byte-squeeze overlap
    device compute. ``depth`` bounds frames in flight. A frame whose
    chunks overflow ``cont``/``capw8`` is retried synchronously up the
    ladder (exact, just slower — overflow is the exception path)."""
    capw8 = capw8 or _capw_tier0(list(qualities or ()), cont)
    pending = deque()

    def _assemble(item):
        words, sizes_u8, okf, planes_dev, h, w = item
        sizes_np = np.asarray(sizes_u8).astype(np.int32)
        if not bool(np.asarray(okf)):
            # overflow: redo this frame synchronously, roomier
            from .device_stream import compress_frame_to_streams
            planes_host = [np.asarray(p) for p in planes_dev]
            qt_np = [np.asarray(q) for q in qtables]
            return compress_frame_to_streams(
                planes_host, qt_np, precision=precision,
                cont0=ds.CONT_MID if cont == ds.CONT_DEFAULT else cont)
        from .. import native
        words_np = np.asarray(words)
        totw = int(((sizes_np.astype(np.int64) + 3) // 4).sum())
        packed = native.repack_words(words_np[:totw], sizes_np, align=1)
        ny = (h // 8) * (w // 8)
        nc = (h // 16) * (w // 16)
        return ds._split_planes(sizes_np, packed, ny, nc)

    for planes_dev in frames:
        y, u, v = planes_dev
        h, w = y.shape
        cA, cC, sizes, total, ok = ds.compress_frame(
            y, u, v, *qtables, precision=precision, cont=cont)
        words, sizes_u8, okf = ds._compact_stream_words(
            cA, cC, sizes, ok, capw8)
        words.copy_to_host_async()
        sizes_u8.copy_to_host_async()
        okf.copy_to_host_async()
        pending.append((words, sizes_u8, okf, planes_dev, h, w))
        while len(pending) > depth:
            yield _assemble(pending.popleft())
    while pending:
        yield _assemble(pending.popleft())


def compress_stream_timed(planes_np, qtables, n_frames: int = 16,
                          **kw):
    """Bench helper: stream ``n_frames`` copies of one frame through
    compress_stream, return (fps, total_bytes of frame 0, streams of
    frame 0) — the pull-inclusive sustained compress rate."""
    dev = tuple(jnp.asarray(p) for p in planes_np)
    first = None
    # warm executables + one pull outside the timed region
    for st in compress_stream([dev], qtables, **kw):
        first = st
    t0 = time.perf_counter()
    k = 0
    for st in compress_stream([dev] * n_frames, qtables, **kw):
        k += 1
    elapsed = time.perf_counter() - t0
    if k != n_frames:
        raise BitstreamError("compress_stream dropped frames")
    total = sum(int(c.size) for _, c in first)
    return n_frames / elapsed, total, first
