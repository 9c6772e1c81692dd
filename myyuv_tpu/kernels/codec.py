"""The word-frame codec kernels: one interface, two implementations.

Both directions of the frame codec are one fused kernel each, and both
speak the packed word layouts of kernels/words.py:

* ``encode(xw, qts, pids, cont)``: pixel frame ``xw [128, NTP]`` ->
  (A ``[64, NTP]``, C ``[8*cont, NTP]``, sizes ``[8*NTP]``, ok
  ``[8*NTP]``) — DCT, quantize and Huffman-encode every block; A and C
  are the dense two-region interchange (engine/device_stream), chunk
  words beyond the chunk are zero and words beyond 8 + cont are dropped
  (ok goes False for such a chunk);
* ``decode(A, C, qts, pids)``: the interchange -> (``xw [128, NP]``, ok
  ``[8*NP]``) — Huffman-decode, dequantize and inverse-DCT every block.

``qts`` is [3, 64] f32 (Y, U, V tables, row-major) and ``pids`` [NTP] i32
the plane of each lane column. Block b = 8c + r is independent of every
other block, so the kernels preserve the column count and need no
padding; frames still pad to ``COLS`` so that no thread block is ragged.

Implementations:

* ``"ffi"``: native/codec_kernels.cu through ``jax.ffi``, one thread per
  block with its state in registers (native/block_codec.h holds the
  per-block arithmetic). On the GPU it is built by nvcc; on the CPU the
  same source built by g++ gives a host build of the same handlers, which
  the CPU tests use.
* ``"xla"``: plain JAX — kernels/device transforms and the lockstep
  entropy coder of entropy/device over all blocks at once.

``default_impl()`` picks ``"ffi"`` on the GPU and ``"xla"`` on the CPU.
A GPU run never falls back: if the kernel library cannot be built or
loaded, the call raises.
"""

from __future__ import annotations

import ctypes

import jax
import jax.numpy as jnp

from . import device as kdev
from . import words
from ..runtime import backend

I32 = jnp.int32
IMPLS = ("ffi", "xla")
# lane columns per kernel thread block (native/codec_kernels.cu kCols):
# word frames and shard slabs align their column counts to it
COLS = 32

_ENCODE = "myyuv_encode_words"
_DECODE = "myyuv_decode_words"
_REGISTERED = set()


def default_impl() -> str:
    """The implementation the codec runs on this platform."""
    return "ffi" if backend.platform() == "gpu" else "xla"


def _resolve(impl: str | None) -> str:
    impl = impl or default_impl()
    if impl not in IMPLS:
        raise ValueError(f"unknown codec implementation {impl!r}")
    return impl


def _register_ffi() -> None:
    """Build (if needed), load and register the kernel library for the
    current platform; raises if it cannot."""
    from .. import native
    plat = backend.platform()
    if plat in _REGISTERED:
        return
    lib = ctypes.cdll.LoadLibrary(str(native.build_codec_kernels(plat)))
    target = "CUDA" if plat == "gpu" else "cpu"
    jax.ffi.register_ffi_target(
        _ENCODE, jax.ffi.pycapsule(lib.MyyuvEncodeWords), platform=target)
    jax.ffi.register_ffi_target(
        _DECODE, jax.ffi.pycapsule(lib.MyyuvDecodeWords), platform=target)
    _REGISTERED.add(plat)


def _block_tables(qts, pids, n: int) -> jnp.ndarray:
    """[3, 64] tables + [NTP] column plane ids -> [n, 8, 8] per block."""
    return jnp.repeat(qts[pids], 8, axis=0)[:n].reshape(n, 8, 8)


def entropy_encode_xla(coeffs):
    """[N, 64] i16 quantized coefficients -> (stream-space words [N, 64]
    i32, sizes [N] i32, ok [N]) through the plain-JAX lockstep encoder
    (entropy/device) — the XLA implementation's entropy stage, shared
    with the plane route of engine/device_stream."""
    from ..entropy import device as edev
    lanes, sizes, ok = edev.encode_lanes(coeffs)
    return words.lanes_to_words(lanes), sizes.astype(I32), ok


def entropy_decode_xla(A, C):
    """Two-region interchange (A [64, NP], C [8*cont, NP]) -> ([8*NP, 64]
    i16 coefficients, [8*NP] ok) through the plain-JAX lockstep decoder."""
    from ..entropy import device as edev
    n = 8 * A.shape[1]
    w = words.unpack_rows8(jnp.concatenate([A, C], axis=0))
    w = jnp.concatenate([w, jnp.zeros((n, 64 - w.shape[1]), I32)], axis=1)
    return edev.decode_lanes(words.words_to_lanes(w))


def _encode_xla(xw, qts, pids, cont: int):
    n = 8 * xw.shape[1]
    coeffs = kdev.dct_quantize(words.words_to_blocks(xw),
                               _block_tables(qts, pids, n))
    w, sizes, ok = entropy_encode_xla(coeffs.reshape(n, 64))
    return (words.pack_rows8(w[:, :8]), words.pack_rows8(w[:, 8:8 + cont]),
            sizes, ok & (sizes <= 4 * (8 + cont)))


def _decode_xla(A, C, qts, pids):
    n = 8 * A.shape[1]
    coeffs, ok = entropy_decode_xla(A, C)
    px = kdev.dequantize_idct(coeffs.reshape(n, 8, 8),
                              _block_tables(qts, pids, n))
    return words.blocks_to_words(px), ok


def _check(xw_or_a, pids, qts):
    if pids.shape != (xw_or_a.shape[1],) or qts.shape != (3, 64):
        raise ValueError(
            f"codec kernel: pids {pids.shape} / qts {qts.shape} do not "
            f"match {xw_or_a.shape[1]} lane columns")


def encode(xw: jnp.ndarray, qts: jnp.ndarray, pids: jnp.ndarray,
           cont: int, impl: str | None = None):
    """Fused DCT + quantize + Huffman encode of a word frame -> (A, C,
    sizes, ok); see the module docstring."""
    _check(xw, pids, qts)
    qts = qts.astype(jnp.float32)
    pids = pids.astype(I32)
    if _resolve(impl) == "xla":
        return _encode_xla(xw, qts, pids, cont)
    _register_ffi()
    ntp = xw.shape[1]
    A, C, sizes, ok = jax.ffi.ffi_call(_ENCODE, (
        jax.ShapeDtypeStruct((64, ntp), I32),
        jax.ShapeDtypeStruct((8 * cont, ntp), I32),
        jax.ShapeDtypeStruct((8 * ntp,), I32),
        jax.ShapeDtypeStruct((8 * ntp,), I32)))(xw.astype(I32), qts, pids)
    return A, C, sizes, ok != 0


def decode(A: jnp.ndarray, C: jnp.ndarray, qts: jnp.ndarray,
           pids: jnp.ndarray, impl: str | None = None):
    """Fused Huffman decode + dequantize + IDCT of the two-region
    interchange -> (xw, ok); see the module docstring."""
    _check(A, pids, qts)
    if A.shape[0] != 64 or C.shape[1] != A.shape[1] or C.shape[0] % 8 \
            or C.shape[0] > 8 * 56:
        raise ValueError(f"codec kernel: bad regions {A.shape}, {C.shape}")
    qts = qts.astype(jnp.float32)
    pids = pids.astype(I32)
    if _resolve(impl) == "xla":
        return _decode_xla(A, C, qts, pids)
    _register_ffi()
    np8 = A.shape[1]
    xw, ok = jax.ffi.ffi_call(_DECODE, (
        jax.ShapeDtypeStruct((128, np8), I32),
        jax.ShapeDtypeStruct((8 * np8,), I32)))(
            A.astype(I32), C.astype(I32), qts, pids)
    return xw, ok != 0
