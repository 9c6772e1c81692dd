"""Batched, sharded codec steps: the pjit surface of the engine.

Frames are batched on a leading axis and sharded over the mesh's ``data``
axis; the block axis of each plane can additionally shard over the ``block``
axis (the sequence-parallel analog for 4K frames, SURVEY.md §5). The only
cross-block reductions in the codec are statistics — per-symbol histograms
(the global Huffman/RD statistics) and distortion sums — which XLA lowers to
``psum``-style collectives over the device interconnect when outputs are
requested replicated.

These functions are pure and jit-once; the ragged entropy stage stays on the
host (engine.pipeline / native), fed by the dense coefficient tensors
produced here.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels import constants, device
from ..parallel import mesh as meshlib

# 11-bit symbol alphabet of the entropy stage (coefficients in [-1024, 1023])
NUM_SYMBOLS = 2048


def plane_qtables(qualities) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Three [8, 8] float32 quality-scaled tables (host-side, static)."""
    return tuple(
        jnp.asarray(constants.quality_scaled_qtable(
            constants.PLANE_Q50[i], int(qualities[i])))
        for i in range(3))


def symbol_histogram(coeffs: jnp.ndarray) -> jnp.ndarray:
    """Global [NUM_SYMBOLS] int32 histogram of quantized coefficients.

    The batched generalization of the reference's per-block frequency
    count (Huffman.cpp:204-212): one scatter-add over the whole batch; under
    pjit the replicated output becomes an all-reduce over the mesh.
    """
    idx = (coeffs.astype(jnp.int32) + 1024).reshape(-1)
    return jnp.zeros((NUM_SYMBOLS,), jnp.int32).at[idx].add(1)


def encode_planes(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
                  qt_y: jnp.ndarray, qt_u: jnp.ndarray, qt_v: jnp.ndarray,
                  precision: str = "exact"):
    """Batched forward transform: [B, H, W]+chroma -> per-plane coefficients."""
    cy = device.dct_quantize(device.plane_to_blocks(y), qt_y, precision)
    cu = device.dct_quantize(device.plane_to_blocks(u), qt_u, precision)
    cv = device.dct_quantize(device.plane_to_blocks(v), qt_v, precision)
    return cy, cu, cv


def decode_planes(cy: jnp.ndarray, cu: jnp.ndarray, cv: jnp.ndarray,
                  qt_y: jnp.ndarray, qt_u: jnp.ndarray, qt_v: jnp.ndarray,
                  h: int, w: int, precision: str = "exact"):
    """Batched inverse transform back to [B, H, W] (+chroma) planes."""
    y = device.blocks_to_plane(device.dequantize_idct(cy, qt_y, precision), h, w)
    u = device.blocks_to_plane(device.dequantize_idct(cu, qt_u, precision),
                               h // 2, w // 2)
    v = device.blocks_to_plane(device.dequantize_idct(cv, qt_v, precision),
                               h // 2, w // 2)
    return y, u, v


def roundtrip_step(y, u, v, qt_y, qt_u, qt_v, precision: str = "exact"
                   ) -> Tuple[Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
                              Dict[str, jnp.ndarray]]:
    """Full device roundtrip (transform -> quantize -> reconstruct) + metrics.

    Returns reconstructed planes and a metrics dict: per-plane squared-error
    sums (for PSNR), the global symbol histogram, and an estimated entropy
    payload size in bits — the RD statistics that run as collectives when
    the batch is sharded (SURVEY.md §5 'distributed communication backend').
    """
    h, w = y.shape[-2], y.shape[-1]
    cy, cu, cv = encode_planes(y, u, v, qt_y, qt_u, qt_v, precision)
    ry, ru, rv = decode_planes(cy, cu, cv, qt_y, qt_u, qt_v, h, w, precision)

    def sq_err(a, b):
        d = a.astype(jnp.float32) - b.astype(jnp.float32)
        return jnp.sum(d * d)

    hist = (symbol_histogram(cy) + symbol_histogram(cu)
            + symbol_histogram(cv))
    p = hist.astype(jnp.float32) / jnp.maximum(jnp.sum(hist), 1)
    entropy_bits = -jnp.sum(jnp.where(p > 0, p * jnp.log2(p), 0.0))
    metrics = {
        "sse_y": sq_err(y, ry),
        "sse_u": sq_err(u, ru),
        "sse_v": sq_err(v, rv),
        "symbol_hist": hist,
        "entropy_bits_per_symbol": entropy_bits,
    }
    return (ry, ru, rv), metrics


@functools.partial(jax.jit, static_argnames=("precision",))
def roundtrip_step_jit(y, u, v, qt_y, qt_u, qt_v, precision="exact"):
    return roundtrip_step(y, u, v, qt_y, qt_u, qt_v, precision)


def make_sharded_roundtrip(mesh, precision: str = "exact"):
    """jit the roundtrip step with explicit shardings over `mesh`.

    Frames shard over ``data``; the within-plane block rows shard over
    ``block``; q-tables are replicated; metrics come back replicated, which
    makes XLA insert the cross-device reductions (psum over NVLink).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    plane = NamedSharding(mesh, meshlib.plane_batch_spec())
    rep = NamedSharding(mesh, P())
    fn = functools.partial(roundtrip_step, precision=precision)
    metrics_sharding = {
        "sse_y": rep, "sse_u": rep, "sse_v": rep,
        "symbol_hist": rep, "entropy_bits_per_symbol": rep,
    }
    return jax.jit(
        fn,
        in_shardings=(plane, plane, plane, rep, rep, rep),
        out_shardings=((plane, plane, plane), metrics_sharding))
