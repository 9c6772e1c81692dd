"""Bit-exactness of the JAX device kernels vs the scalar (NumPy) oracle.

The scalar oracle (kernels.scalar) is itself validated against the compiled
reference CLI in test_host_codec.py; equality here makes the jitted device
path transitively bit-exact with myyuv_cli.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from myyuv_tpu.kernels import device, scalar  # noqa: E402


def _rand_blocks(rng, n=257):
    return rng.integers(0, 256, size=(n, 8, 8), dtype=np.uint8)


def _rand_coeffs(rng, n=257):
    # valid coefficient range (DCT.cpp:274-275)
    return rng.integers(-1024, 1024, size=(n, 8, 8), dtype=np.int16)


@pytest.mark.parametrize("quality", [1, 10, 50, 90, 100])
@pytest.mark.parametrize("plane", [0, 1])
def test_dct_quantize_bitexact(rng, quality, plane):
    blocks = _rand_blocks(rng)
    qt = scalar.plane_qtable(plane, quality)
    want = scalar.dct_quantize_blocks(blocks, qt)
    got = np.asarray(device.dct_quantize(jnp.asarray(blocks), jnp.asarray(qt)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", [1, 50, 100])
def test_dequantize_idct_bitexact(rng, quality):
    coeffs = _rand_coeffs(rng)
    qt = scalar.plane_qtable(0, quality)
    want = scalar.dequantize_idct_blocks(coeffs, qt)
    got = np.asarray(device.dequantize_idct(jnp.asarray(coeffs), jnp.asarray(qt)))
    np.testing.assert_array_equal(got, want)


def test_roundtrip_via_plane_helpers(rng):
    h, w = 64, 128
    plane = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    qt = scalar.plane_qtable(0, 50)
    coeffs = device.dct_quantize_plane(jnp.asarray(plane), jnp.asarray(qt))
    want = scalar.dct_quantize_blocks(scalar.plane_to_blocks(plane), qt)
    np.testing.assert_array_equal(np.asarray(coeffs), want)
    rec = device.dequantize_idct_plane(coeffs, jnp.asarray(qt), h, w)
    want_rec = scalar.blocks_to_plane(
        scalar.dequantize_idct_blocks(want, qt), h, w)
    np.testing.assert_array_equal(np.asarray(rec), want_rec)


def test_batched_shapes(rng):
    b = rng.integers(0, 256, size=(4, 32, 8, 8), dtype=np.uint8)
    qt = scalar.plane_qtable(0, 50)
    got = np.asarray(device.dct_quantize(jnp.asarray(b), jnp.asarray(qt)))
    for i in range(4):
        np.testing.assert_array_equal(
            got[i], scalar.dct_quantize_blocks(b[i], qt))


def test_bgrx_to_iyuv_bitexact(rng):
    h, w = 34, 52
    px = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    wy, wu, wv = scalar.bgrx_to_iyuv(px)
    gy, gu, gv = device.bgrx_to_iyuv(jnp.asarray(px))
    np.testing.assert_array_equal(np.asarray(gy), wy)
    np.testing.assert_array_equal(np.asarray(gu), wu)
    np.testing.assert_array_equal(np.asarray(gv), wv)


def test_iyuv_to_bgrx_matches_scalar(rng):
    h, w = 16, 24
    y = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    u = rng.integers(0, 256, size=(h // 2, w // 2), dtype=np.uint8)
    v = rng.integers(0, 256, size=(h // 2, w // 2), dtype=np.uint8)
    want = scalar.iyuv_to_bgrx(y, u, v)
    got = np.asarray(device.iyuv_to_bgrx(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_array_equal(got, want)


def test_round_half_away_edge_cases():
    # 0.5 - 2^-25 must round to 0, not 1 (floor(x+0.5) bug); halves away
    xs = np.array([0.5 - 2.0 ** -25, 0.5, -0.5, 1.5, -1.5, 2.5, -2.5,
                   0.0, -0.0, 100.49999, -100.5], np.float32)
    want = np.array([0, 1, -1, 2, -2, 3, -3, 0, 0, 100, -101], np.float32)
    got = np.asarray(device.round_half_away(jnp.asarray(xs)))
    np.testing.assert_array_equal(got, want)


def test_fast_precision_close(rng):
    """Matmul fast path: coefficients within +-1 of exact (not bit-exact)."""
    blocks = _rand_blocks(rng, 64)
    qt = scalar.plane_qtable(0, 50)
    exact = scalar.dct_quantize_blocks(blocks, qt)
    fast = np.asarray(device.dct_quantize(
        jnp.asarray(blocks), jnp.asarray(qt), precision="fast"))
    assert np.abs(fast.astype(np.int32) - exact.astype(np.int32)).max() <= 1
