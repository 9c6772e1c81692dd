"""JAX device kernels: batched, jittable, bit-exact codec compute.

The plain-JAX compute path of the framework. Every function here is traced
once under ``jax.jit`` and reproduces the reference's scalar float32
arithmetic *bit-for-bit* (validated against kernels.scalar in
tests/test_device_kernels.py, on the GPU by chip_smoke.py, and transitively
against the compiled reference CLI):

* The 8x8 DCT-II matmuls (reference: DCT.cpp:232-277 squareMatrixMul /
  applyDCTBlock) are evaluated as **sequential elementwise ops** — one f32
  multiply and one f32 add per k-step, rounded after every op exactly like
  the reference's scalar loop. They deliberately do NOT use a matrix unit:
  its products accumulate in another order (and a float32 product on the
  GPU may run in TF32), which would break bit-exactness of the quantized
  coefficients.

* ``precision="fast"`` switches the transforms to einsums at HIGHEST
  precision for throughput experiments; coefficients may then differ by
  +-1 in rare round-to-half cases, so the default is "exact".

All kernels are batched: a leading ``[...]`` batch/block axis is mandatory
nowhere and broadcast everywhere, so the same code serves one plane, one
image, or a sharded [B, ...] batch under pjit (engine.pipeline).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .constants import DCT_MATRIX8

F32 = jnp.float32


def round_half_away(x: jnp.ndarray) -> jnp.ndarray:
    """Exact float32 std::round (half away from zero) — DCT.cpp:273,358.

    trunc + fractional compare; ``x - trunc(x)`` is exact in IEEE f32
    (Sterbenz lemma), unlike floor(x + 0.5) which misrounds 0.5 - 2^-25.
    """
    r = jnp.trunc(x)
    f = x - r
    bump = jnp.where(jnp.abs(f) >= F32(0.5), jnp.sign(x), F32(0))
    return r + bump.astype(F32)


def _seq_matmul(a: jnp.ndarray, b: jnp.ndarray,
                z: jnp.ndarray) -> jnp.ndarray:
    """[..., 8, 8] @ [..., 8, 8] with ascending-k sequential f32 rounding.

    Bit-exact model of squareMatrixMul (DCT.cpp:232-242): the accumulator is
    rounded to f32 after every multiply and every add, no reassociation.

    ``a`` and ``b`` may be [8, 8] constants or [..., 8, 8] batches; slices
    broadcast against each other, which keeps the DCT matrix a tiny [8, 1]
    constant per step — pre-broadcasting it to the batch shape makes XLA
    constant-fold N-sized literals through the (interpreted) HLO evaluator
    and compile time blows up linearly with N.

    ``z`` must be a RUNTIME float32 zero (derived from a traced input, e.g.
    ``x.ravel()[0] * 0``). Each product is emitted as ``(a_k * b_k) + z``:
    compilers may contract a multiply feeding an add into one
    single-rounded FMA (the GPU's PTX mul/add pairs are fair game for
    ptxas) — which breaks bit-exactness vs the reference's double rounding.
    With the runtime ``+ z`` the backend either fuses to fma(a, b, 0) ==
    RN(a*b) or leaves RN(RN(a*b) + 0) — identical either way, while the
    accumulator add no longer consumes a raw multiply. (XLA cannot fold
    runtime ``x + 0``/``x * 0``: that is IEEE-invalid without fast-math.
    chip_smoke.py checks the result bit for bit on the card.)
    """
    acc = (a[..., :, 0:1] * b[..., 0:1, :]) + z
    for k in range(1, 8):
        acc = acc + ((a[..., :, k:k + 1] * b[..., k:k + 1, :]) + z)
    return acc


def _runtime_zero(x: jnp.ndarray) -> jnp.ndarray:
    """A float32 zero the compiler cannot constant-fold (see _seq_matmul).

    Element indexing, NOT ``x.reshape(-1)[0]``: reshaping a large array
    just to take element 0 sends XLA's reshape/layout passes on a tour
    that scales compile time with the array size (observed 285 s vs 0.5 s
    at [17112, 8, 8] on CPU).
    """
    return x[(0,) * x.ndim].astype(F32) * F32(0)


def _exact_quantize(coef: jnp.ndarray, qtable: jnp.ndarray) -> jnp.ndarray:
    """int16 RHA(RN_f32(coef / q)) with exact boundary semantics.

    The reference quantizes as ``int16(std::round(coef / q))`` with IEEE
    correctly-rounded f32 division (DCT.cpp:273). A backend whose division
    is only faithfully rounded (e.g. 62.999996/14 -> 4.5 instead of the
    correctly-rounded 4.4999995) flips the result exactly at half-integer
    boundaries, so the division never decides. Division-free correction:

    For positive a and integer q, the result is
        N = #{k >= 0 : RN(a/q) >= k + 0.5}
    and ``RN(a/q) >= B`` (B = k + 0.5) iff ``a/q >=(tie) theta`` where
    theta = midpoint(pred(B), B), with equality admitted iff B's mantissa
    is even (ties-to-even). Multiplying through by q:
        a >=(tie) theta*q = B*q - (ulp_below(B)/2)*q
    where both products are EXACT in f32 (B has <= 12 significand bits and
    ulp/2 is a power of two; q is an integer <= 255, 8 bits), and
    ``c1 = a - B*q`` is exact by Sterbenz whenever the test is nontrivial
    (a within 2x of B*q). So ``a >= theta*q  <=>  c1 >=(tie) -p2`` with
    every quantity exact. The approximate quotient only seeds the integer
    candidate; both adjacent boundaries are re-decided exactly, absorbing
    any +-1 ulp division error.
    """
    q = qtable.astype(F32)
    a = jnp.abs(coef)
    sign = jnp.where(coef < 0, jnp.int32(-1), jnp.int32(1))
    t = a / q                                   # faithful, maybe 1 ulp off
    n0 = jnp.trunc(t + F32(0.5))                # candidate integer, f32

    def ge_tie(b_f32):
        """exact [a/q >= RN-threshold-below(b_f32)] elementwise."""
        p1 = b_f32 * q                          # exact: <= 20 bits
        bits = jax.lax.bitcast_convert_type(b_f32, jnp.int32)
        exp = (bits >> 23) & 0xFF
        is_pow2 = (bits & 0x7FFFFF) == 0
        half_ulp_exp = exp - 24 - is_pow2.astype(jnp.int32)
        half_ulp = jax.lax.bitcast_convert_type(
            half_ulp_exp << 23, jnp.float32)
        p2 = half_ulp * q                       # exact: 1 x 8 bits
        c1 = a - p1                             # exact (Sterbenz near tie)
        even = (bits & 1) == 0                  # B mantissa parity
        # boolean algebra instead of where(even, >=, >)
        return (c1 > -p2) | (even & (c1 == -p2))

    lo = ge_tie(n0 - F32(0.5))
    hi = ge_tie(n0 + F32(0.5))
    n = (n0.astype(jnp.int32) - 1 + lo.astype(jnp.int32)
         + hi.astype(jnp.int32))
    return (sign * n).astype(jnp.int16)


def _dct_mats():
    """([8, 8] f32 C, C^T) as NUMPY constants: jnp ops treat them as
    trace-time literals. Deliberately NOT module-level jnp arrays (that
    initializes the JAX backend at import, breaking
    jax.distributed.initialize in multi-process programs) and NOT an
    lru_cache of jnp.asarray (a first call inside a trace would cache a
    leaked tracer)."""
    return DCT_MATRIX8, _DCT_MATRIX8_T


_DCT_MATRIX8_T = np.ascontiguousarray(DCT_MATRIX8.T)


def _matmul_transform(left: jnp.ndarray, x: jnp.ndarray,
                   right: jnp.ndarray) -> jnp.ndarray:
    """left @ x @ right as matrix products (fast path, not bit-exact)."""
    hi = jax.lax.Precision.HIGHEST
    t = jnp.einsum("ik,...kl->...il", left, x, precision=hi)
    return jnp.einsum("...il,lj->...ij", t, right, precision=hi)


def dct_quantize(blocks_u8: jnp.ndarray, qtable: jnp.ndarray,
                 precision: str = "exact") -> jnp.ndarray:
    """[..., 8, 8] uint8 pixels -> [..., 8, 8] int16 quantized coefficients.

    applyDCTBlock semantics (DCT.cpp:269-277): center by -128, C.B, then
    (C.B).C^T, divide by the quality-scaled table, round half away from
    zero. The divide-and-round is evaluated by the division-free
    boundary-exact _exact_quantize (IEEE division rounding is part of the
    bit-exactness contract; a backend's fast division need not honour it).
    """
    x = blocks_u8.astype(F32) - F32(128)
    if precision == "exact":
        z = _runtime_zero(qtable)
        _C, _CT = _dct_mats()
        t = _seq_matmul(_C, x, z)
        coef = _seq_matmul(t, _CT, z)
        return _exact_quantize(coef, qtable)
    _C, _CT = _dct_mats()
    coef = _matmul_transform(_C, x, _CT)
    return round_half_away(coef / qtable.astype(F32)).astype(jnp.int16)


def dequantize_idct(coeffs: jnp.ndarray, qtable: jnp.ndarray,
                    precision: str = "exact") -> jnp.ndarray:
    """[..., 8, 8] int16 coefficients -> [..., 8, 8] uint8 pixels.

    restoreDCTBlock semantics (DCT.cpp:325-335): dequantize, C^T.X, then
    (C^T.X).C, then clamp(round(x) + 128, 0, 255) (DCT.cpp:358-361).
    """
    x = coeffs.astype(F32) * qtable.astype(F32)
    if precision == "exact":
        z = _runtime_zero(qtable)
        _C, _CT = _dct_mats()
        t = _seq_matmul(_CT, x, z)
        pix = _seq_matmul(t, _C, z)
    else:
        _C, _CT = _dct_mats()
        pix = _matmul_transform(_CT, x, _C)
    r = round_half_away(pix).astype(jnp.int32) + 128
    return jnp.clip(r, 0, 255).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Plane <-> raster-ordered 8x8 blocks (DCT.cpp:308,355 block indexing)
# ---------------------------------------------------------------------------

def plane_to_blocks(plane: jnp.ndarray) -> jnp.ndarray:
    """[..., H, W] -> [..., H/8 * W/8, 8, 8] raster-ordered tiles."""
    *lead, h, w = plane.shape
    x = plane.reshape(*lead, h // 8, 8, w // 8, 8)
    x = jnp.moveaxis(x, -3, -2)
    return x.reshape(*lead, (h // 8) * (w // 8), 8, 8)


def blocks_to_plane(blocks: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """[..., N, 8, 8] -> [..., H, W]."""
    *lead, _, _, _ = blocks.shape
    x = blocks.reshape(*lead, h // 8, w // 8, 8, 8)
    x = jnp.moveaxis(x, -2, -3)
    return x.reshape(*lead, h, w)


# ---------------------------------------------------------------------------
# RGB <-> IYUV
# ---------------------------------------------------------------------------

def bgrx_to_iyuv(pixels: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray,
                                               jnp.ndarray]:
    """[..., H, W, 4] uint8 BGRX (top-down) -> (Y, U, V) planes.

    Bit-exact model of the IYUV converter (myyuv_yuv.cpp:34-52,88-127):
    float32 BT.601-style luma with truncating u8 cast, chroma as truncating
    cast + 128 with wraparound, and 4:2:0 chroma equal to the *sum of
    per-sample divide_roundnearest(c, 4)* over each 2x2 quad (NOT the
    rounded mean — differs by up to +-2 LSB, myyuv_yuv.cpp:114-121).

    Channels extract from bitcast [..., H, W] i32 pixel words rather than
    a [..., 4]-minor u8 layout.
    """
    yv, uv, vv = bgrx_to_iyuv_vals(pixels)
    return (yv.astype(jnp.uint8), uv.astype(jnp.uint8),
            vv.astype(jnp.uint8))


def bgrx_to_iyuv_vals(pixels: jnp.ndarray) -> Tuple[jnp.ndarray,
                                                    jnp.ndarray,
                                                    jnp.ndarray]:
    """bgrx_to_iyuv returning i32 VALUE planes (0..255) — the word-frame
    values feed further integer math without a u8 round trip. Identical
    per-element math."""
    w32 = jax.lax.bitcast_convert_type(pixels, jnp.int32)  # [..., H, W]
    b = (w32 & 255).astype(F32)
    g = ((w32 >> 8) & 255).astype(F32)
    r = ((w32 >> 16) & 255).astype(F32)
    # runtime zeros keep the compiler from contracting the mul+add chains
    # into single-rounded FMAs (see _seq_matmul)
    z = _runtime_zero(b)
    yf = ((F32(0.299) * r + z) + (F32(0.587) * g + z)) + (F32(0.114) * b + z)
    y = jnp.trunc(yf).astype(jnp.int32)
    cb = (jnp.trunc((b - yf) * F32(0.564)).astype(jnp.int32) + 128) & 255
    cr = (jnp.trunc((r - yf) * F32(0.713)).astype(jnp.int32) + 128) & 255
    qcb = (cb + 2) >> 2
    qcr = (cr + 2) >> 2

    # BOTH chroma channels in ONE 2x2 reduce_window over packed
    # qcb | qcr << 16 fields (per-channel quad sums <= 256 never cross
    # the field boundary; i32 adds are order-exact), instead of two
    # reduce_windows or strided slices.
    t = qcb | (qcr << 16)
    lead = (1,) * (t.ndim - 2)
    s = jax.lax.reduce_window(t, 0, jax.lax.add,
                              lead + (2, 2), lead + (2, 2), "VALID")
    return y, (s & 255), (s >> 16) & 255


def iyuv_to_bgrx(y: jnp.ndarray, u: jnp.ndarray,
                 v: jnp.ndarray) -> jnp.ndarray:
    """IYUV planes -> [..., H, W, 4] uint8 BGRX preview.

    The RGB export math of the reference's fragment shader
    (myyuv_opengl/viewer/frag_yuv.glsl): R = Y + 1.403 V', G = Y - 0.714 V'
    - 0.344 U', B = Y + 1.773 U', chroma centered, evaluated in [0,255].
    """
    h, w = y.shape[-2], y.shape[-1]
    lead = y.shape[:-2]
    hc, wc = u.shape[-2], u.shape[-1]
    if h == 2 * hc and w == 2 * wc:
        # 2x chroma upsample WITHOUT interleaves, on fully dense shapes:
        # the minor-axis repeat rides a (c | c << 16) -> u16 bitcast
        # (each i32 word splits into two identical u16 values), and the
        # row-axis repeat flattens each Y row PAIR onto the minor axis
        # (y.reshape(H/2, 2W) is free) so the chroma row just tiles
        # twice. Per-element math identical to jnp.repeat.
        def up(c):
            ci = c.astype(jnp.int32)
            d16 = jax.lax.bitcast_convert_type(ci | (ci << 16),
                                               jnp.uint16)
            d = d16.reshape(*lead, hc, w)
            return jnp.concatenate([d, d], axis=-1).astype(F32) \
                - F32(128)
        uu = up(u)
        vv = up(v)
        yf = y.reshape(*lead, hc, 2 * w).astype(F32)
    else:
        uu = jnp.repeat(jnp.repeat(u, 2, -2), 2, -1)[..., :h, :w] \
            .astype(F32) - F32(128)
        vv = jnp.repeat(jnp.repeat(v, 2, -2), 2, -1)[..., :h, :w] \
            .astype(F32) - F32(128)
        yf = y.astype(F32)
    z = _runtime_zero(yf)
    r = yf + (F32(1.403) * vv + z)
    g = (yf - (F32(0.714) * vv + z)) - (F32(0.344) * uu + z)
    b = yf + (F32(1.773) * uu + z)

    def chan(x):
        return jnp.clip(jnp.rint(x), 0, 255).astype(jnp.int32)

    # emit packed pixel words and bitcast to the byte layout (see
    # bgrx_to_iyuv: no [..., 4]-minor u8 stack)
    word = chan(b) | (chan(g) << 8) | (chan(r) << 16) \
        | jnp.int32(-16777216)          # 0xFF000000: alpha byte
    # barrier: without it XLA hoists the (tiled-layout, hence real-copy)
    # [H/2, 2W] -> [H, W] reshape above the word-pack fusion and
    # materializes each f32 channel separately (4 copies, measured)
    word = jax.lax.optimization_barrier(word)
    word = word.reshape(*lead, h, w)

    return jax.lax.bitcast_convert_type(word, jnp.uint8)


# ---------------------------------------------------------------------------
# Whole-plane fused transforms (jitted entry points)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("precision",))
def dct_quantize_plane(plane: jnp.ndarray, qtable: jnp.ndarray,
                       precision: str = "exact") -> jnp.ndarray:
    """[..., H, W] uint8 -> [..., H/8*W/8, 8, 8] int16 coefficients."""
    return dct_quantize(plane_to_blocks(plane), qtable, precision)


def unfuse(x: jnp.ndarray) -> jnp.ndarray:
    """Materialization barrier between the inverse transform and the
    blocks->plane relayout, which XLA otherwise fuses into one slower
    kernel; the barrier keeps each at its solo speed. The forward
    direction fuses profitably and takes no barrier. (Kept from the
    first target; not yet re-measured on the GPU.)"""
    return jax.lax.optimization_barrier(x)


@functools.partial(jax.jit, static_argnames=("h", "w", "precision"))
def dequantize_idct_plane(coeffs: jnp.ndarray, qtable: jnp.ndarray,
                          h: int, w: int,
                          precision: str = "exact") -> jnp.ndarray:
    """[..., N, 8, 8] int16 -> [..., H, W] uint8 plane."""
    return blocks_to_plane(unfuse(dequantize_idct(coeffs, qtable,
                                                  precision)), h, w)
