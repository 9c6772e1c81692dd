"""Plain-JAX (device) lockstep entropy codec vs the native/py oracles.

Small fixed N keeps compile time bounded; the persistent compile cache
(conftest) makes repeat runs instant.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from myyuv_tpu.entropy import (decode_blocks_py, device as edev,  # noqa: E402
                               encode_blocks_py)
from myyuv_tpu.formats.dct_stream import DCTPlaneStream  # noqa: E402

N = 512  # single compiled shape for the whole module


def _blocks(rng, density=0.25):
    c = rng.integers(-1024, 1024, size=(N, 64))
    mask = rng.random((N, 64)) < density
    c = (c * mask).astype(np.int16)
    c[0] = 0          # all-zero block
    c[1] = 1023       # dense extreme
    c[2] = -1024
    c[3, 0] = 7       # single-symbol message
    return c


@pytest.fixture(scope="module")
def coeffs():
    return _blocks(np.random.default_rng(17))


@pytest.fixture(scope="module")
def encoded(coeffs):
    lanes, sizes, ok = edev.encode_lanes(jnp.asarray(coeffs))
    return (np.asarray(lanes), np.asarray(sizes), np.asarray(ok))


def test_encode_ok_and_sizes_optimal(coeffs, encoded):
    lanes, sizes, ok = encoded
    assert ok.all()
    py_sizes, _ = encode_blocks_py(coeffs)
    np.testing.assert_array_equal(sizes.astype(np.uint8), py_sizes)


def test_oracle_decodes_device_encoded(coeffs, encoded):
    lanes, sizes, ok = encoded
    st = DCTPlaneStream.from_lanes(lanes, sizes.astype(np.uint8))
    dec = decode_blocks_py(st.chunk_sizes, st.content)
    np.testing.assert_array_equal(dec, coeffs)


def test_device_decodes_oracle_encoded(coeffs):
    py_sizes, py_content = encode_blocks_py(coeffs)
    lanes = DCTPlaneStream(py_sizes, py_content).to_lanes()
    dec, ok = edev.decode_lanes(jnp.asarray(lanes))
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(dec), coeffs)


def test_device_roundtrip(coeffs, encoded):
    lanes, sizes, ok = encoded
    dec, dok = edev.decode_lanes(jnp.asarray(lanes))
    assert np.asarray(dok).all()
    np.testing.assert_array_equal(np.asarray(dec), coeffs)


def test_corrupt_chunk_flagged(coeffs, encoded):
    lanes, sizes, ok = encoded
    bad = lanes.copy()
    bad[5, 0] ^= 0xFF  # clobber enc_bits of row 5
    _, ok2 = edev.decode_lanes(jnp.asarray(bad))
    ok2 = np.asarray(ok2)
    assert not ok2[5]
    assert ok2[6:].all()


def _oversized_tree_lane():
    """A chunk whose tree section declares 96 symbols (> the 64 max).

    The reference decoder throws on such streams; the device decoders must
    flag the row bad instead of silently dropping symbols.
    """
    chunk = bytearray()
    chunk += (0).to_bytes(2, "little")          # enc_bits = 0
    group = bytes([((8 - 1) << 5) | 31]) + bytes(44)  # 32 syms of len 8
    tree = group * 3                            # 96 symbols total
    chunk.append(len(tree))                     # tree_data_size = 135
    chunk += tree
    lane = np.zeros((256,), np.uint8)
    lane[: len(chunk)] = np.frombuffer(bytes(chunk), np.uint8)
    return lane


def test_oversized_tree_flagged_xla(coeffs, encoded):
    lanes, sizes, ok = encoded
    bad = lanes.copy()
    bad[7] = _oversized_tree_lane()
    _, ok2 = edev.decode_lanes(jnp.asarray(bad))
    ok2 = np.asarray(ok2)
    assert not ok2[7]
    assert ok2[8:].all()
