"""Sharded batch engine on the virtual 8-device CPU mesh.

Validates the multi-chip design without hardware (SURVEY.md §4): frames
shard over the ``data`` axis, block rows over ``block``; replicated metrics
force XLA to insert the cross-device reductions (psum over NVLink on
real hardware).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from myyuv_tpu.engine import batch as eb  # noqa: E402
from myyuv_tpu.kernels import scalar  # noqa: E402
from myyuv_tpu.parallel import mesh as meshlib  # noqa: E402


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return meshlib.make_mesh((4, 2))


def _batch(rng, b, h, w):
    return (rng.integers(0, 256, (b, h, w), np.uint8),
            rng.integers(0, 256, (b, h // 2, w // 2), np.uint8),
            rng.integers(0, 256, (b, h // 2, w // 2), np.uint8))


def test_sharded_roundtrip_matches_scalar(mesh, rng):
    y, u, v = _batch(rng, 4, 32, 64)
    qts = eb.plane_qtables([50, 60, 70])
    fn = eb.make_sharded_roundtrip(mesh)
    with mesh:
        (ry, ru, rv), metrics = fn(jnp.asarray(y), jnp.asarray(u),
                                   jnp.asarray(v), *qts)
    for plane, recon, qi in ((y, ry, 0), (u, ru, 1), (v, rv, 2)):
        qt = scalar.plane_qtable(qi, [50, 60, 70][qi])
        for b in range(plane.shape[0]):
            want = scalar.blocks_to_plane(
                scalar.dequantize_idct_blocks(
                    scalar.dct_quantize_blocks(
                        scalar.plane_to_blocks(plane[b]), qt), qt),
                *plane.shape[1:])
            np.testing.assert_array_equal(np.asarray(recon[b]), want)


def test_sharded_metrics_are_global(mesh, rng):
    y, u, v = _batch(rng, 4, 32, 64)
    qts = eb.plane_qtables([50, 50, 50])
    fn = eb.make_sharded_roundtrip(mesh)
    with mesh:
        _, metrics = fn(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), *qts)
    hist = np.asarray(metrics["symbol_hist"])
    # every quantized coefficient is counted exactly once across all shards
    assert hist.sum() == (y.size + u.size + v.size)
    # sanity: unsharded path agrees
    (_, _, _), m2 = eb.roundtrip_step_jit(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), *qts)
    np.testing.assert_array_equal(hist, np.asarray(m2["symbol_hist"]))
    assert np.isclose(float(metrics["sse_y"]), float(m2["sse_y"]))


def test_mesh_shapes():
    m = meshlib.make_mesh()
    assert m.axis_names == (meshlib.DATA_AXIS, meshlib.BLOCK_AXIS)
    with pytest.raises(ValueError):
        meshlib.make_mesh((3, 5))
