"""Quality sweeps and rate-distortion statistics.

The batch-analytics driver of the engine (a frame stream with a quality
sweep, e.g. q in {10,30,50,70,90}, and a per-quality RD curve): for each
quality, run the device roundtrip step, reduce distortion and the
global symbol histogram (collectives under pjit), and measure the actual
entropy-coded size via the configured entropy backend.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

import jax.numpy as jnp

from .. import entropy
from ..runtime.errors import BitstreamError
from . import batch as eb


def _timed(fn, reps: int = 8) -> float:
    """Seconds per call: one warm-up, then ``reps`` calls ending in
    block_until_ready."""
    import time

    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return max(time.perf_counter() - t0, 1e-9) / reps


def _device_rate(y, u, v, qts, q: int, time_device: bool,
                 precision: str):
    """Rate (and optionally throughput) from the FLAGSHIP device codec:
    compressed size measured from compress_frame's sizes/total — the
    bytes the device entropy coder actually produces (a device-entropy
    rate bug shows up here, unlike the host-backend sweep). Throughput
    includes the FUSED roundtrip executable (the production transcode
    path)."""
    from . import device_stream as ds

    h, w = y.shape
    n = (h // 8) * (w // 8) + 2 * (h // 16) * (w // 16)
    c0 = ds.cont_for_quality(q)
    conts = (ds.CONT_LADDER if c0 is None
             else tuple(t for t in ds.CONT_LADDER if t >= c0))
    cA = cC = sizes = total = None
    for cont in conts:
        cA, cC, sizes, total, ok = ds.compress_frame(
            y, u, v, *qts, precision=precision, cont=cont)
        if bool(ok):
            break
    else:
        raise BitstreamError("device compress overflow")
    comp_bytes = int(total) + n + 3 * 8 + 12
    enc_s = dec_s = rt_s = None
    if time_device:
        enc_s = _timed(lambda: ds.compress_frame(
            y, u, v, *qts, precision=precision, cont=cont)[0])
        dec_s = _timed(lambda: ds.decompress_frame(
            cA, cC, sizes, *qts, h=h, w=w, precision=precision)[0])
        rt_s = _timed(lambda: ds.roundtrip_frame(
            y, u, v, *qts, precision=precision, cont=cont)[0])
    return comp_bytes, enc_s, dec_s, rt_s


def quality_sweep(planes: Sequence[np.ndarray],
                  qualities: Sequence[int] = (10, 30, 50, 70, 90),
                  entropy_backend: Optional[str] = None,
                  precision: str = "exact",
                  time_device: bool = False) -> List[Dict]:
    """Per-quality RD point for one frame's (y, u, v) planes.

    Returns a list of dicts: quality, psnr_y/u/v (dB), compressed_bytes,
    bits_per_pixel, entropy_bits_per_symbol (Shannon bound from the global
    histogram — how close the per-block Huffman gets to optimal).
    ``entropy_backend="device"`` measures the rate from the flagship
    device codec (compress_frame) instead of the host coder, and with
    ``time_device=True`` adds per-quality device encode/decode seconds.
    """
    y, u, v = [jnp.asarray(p) for p in planes]
    out = []
    npix = planes[0].size + planes[1].size + planes[2].size
    for q in qualities:
        qt_y, qt_u, qt_v = eb.plane_qtables([q, q, q])
        (ry, ru, rv), m = eb.roundtrip_step_jit(y, u, v, qt_y, qt_u, qt_v,
                                                precision=precision)
        enc_s = dec_s = rt_s = None
        if entropy_backend == "device":
            comp_bytes, enc_s, dec_s, rt_s = _device_rate(
                y, u, v, (qt_y, qt_u, qt_v), q, time_device, precision)
        else:
            cy, cu, cv = eb.encode_planes(y, u, v, qt_y, qt_u, qt_v,
                                          precision)
            comp_bytes = 0
            for c in (cy, cu, cv):
                sizes, content = entropy.encode_blocks(
                    np.asarray(c).reshape(-1, 64), backend=entropy_backend)
                comp_bytes += int(content.size) + int(sizes.size) + 8
            comp_bytes += 12

        def psnr(sse, n):
            mse = float(sse) / n
            return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))

        pt = {
            "quality": int(q),
            "psnr_y_db": round(psnr(m["sse_y"], planes[0].size), 3),
            "psnr_u_db": round(psnr(m["sse_u"], planes[1].size), 3),
            "psnr_v_db": round(psnr(m["sse_v"], planes[2].size), 3),
            "compressed_bytes": comp_bytes,
            "bits_per_pixel": round(8 * comp_bytes / npix, 4),
            "entropy_bits_per_symbol": round(
                float(m["entropy_bits_per_symbol"]), 4),
        }
        if enc_s is not None:
            pt["device_encode_fps"] = round(1 / enc_s, 2)
            pt["device_decode_fps"] = round(1 / dec_s, 2)
            pt["device_roundtrip_fps"] = round(1 / rt_s, 2)
        out.append(pt)
    return out
