"""Sharded FLAGSHIP codec on the virtual 8-device CPU mesh.

These tests pin the sharded contract: the production frame pipeline (dense two-region interchange)
runs under shard_map with plane block rows contiguous over the mesh,
and produces the SAME BYTES as the single-device path — including a
full .myyuv file assembled from the mesh, and batches composed through
shard_batch/gather_streams.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from myyuv_tpu import entropy  # noqa: E402
from myyuv_tpu.engine import sharded_stream as ss  # noqa: E402
from myyuv_tpu.kernels import scalar  # noqa: E402
from myyuv_tpu.parallel import mesh as meshlib  # noqa: E402


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return meshlib.make_mesh((4, 2))


def _plane(rng, h, w):
    # smooth-ish content so chunk sizes vary across blocks
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(np.uint8)
    noise = rng.integers(0, 24, (h, w), np.uint8)
    return (base + noise).astype(np.uint8)


def _frame(rng, h, w):
    return [_plane(rng, h, w), _plane(rng, h // 2, w // 2),
            _plane(rng, h // 2, w // 2)]


def _want_streams(planes, qts):
    out = []
    for p, plane in enumerate(planes):
        co = scalar.dct_quantize_blocks(
            scalar.plane_to_blocks(plane), qts[p])
        out.append(entropy.encode_blocks(
            co.reshape(-1, 64).astype(np.int16)))
    return out


def _want_recon(planes, qts):
    out = []
    for p, plane in enumerate(planes):
        co = scalar.dct_quantize_blocks(
            scalar.plane_to_blocks(plane), qts[p])
        out.append(scalar.blocks_to_plane(
            scalar.dequantize_idct_blocks(co, qts[p]), *plane.shape))
    return out


def test_sharded_frame_bytes_identical(mesh, rng):
    """8-device frame compress == the host coder, byte for byte; the
    chroma planes (32 rows over 8 devices) exercise row padding."""
    h, w = 64, 128
    planes = _frame(rng, h, w)
    qts = [np.asarray(scalar.plane_qtable(i, 50), np.float32)
           for i in range(3)]
    streams = ss.compress_frame_sharded(mesh, planes, qts)
    want = _want_streams(planes, qts)
    for p in range(3):
        np.testing.assert_array_equal(
            streams[p][0].astype(np.int64), want[p][0])
        np.testing.assert_array_equal(streams[p][1], want[p][1])


def test_sharded_frame_roundtrip(mesh, rng):
    h, w = 64, 128
    planes = _frame(rng, h, w)
    qts = [np.asarray(scalar.plane_qtable(i, 70), np.float32)
           for i in range(3)]
    streams = ss.compress_frame_sharded(mesh, planes, qts)
    ry, ru, rv = ss.decompress_frame_sharded(mesh, streams, qts, h, w)
    want = _want_recon(planes, qts)
    np.testing.assert_array_equal(ry, want[0])
    np.testing.assert_array_equal(ru, want[1])
    np.testing.assert_array_equal(rv, want[2])


def test_sharded_heavy_padding(mesh, rng):
    """Chroma 24 rows -> 3 block rows over 8 devices: most devices hold
    only padding chunks; they must drop cleanly at assembly."""
    h, w = 48, 64
    planes = _frame(rng, h, w)
    qts = [np.asarray(scalar.plane_qtable(i, 50), np.float32)
           for i in range(3)]
    streams = ss.compress_frame_sharded(mesh, planes, qts)
    want = _want_streams(planes, qts)
    for p in range(3):
        np.testing.assert_array_equal(
            streams[p][0].astype(np.int64), want[p][0])
        np.testing.assert_array_equal(streams[p][1], want[p][1])
    ry, ru, rv = ss.decompress_frame_sharded(mesh, streams, qts, h, w)
    want_r = _want_recon(planes, qts)
    np.testing.assert_array_equal(ry, want_r[0])
    np.testing.assert_array_equal(ru, want_r[1])


def test_sharded_batch_streams(mesh, rng):
    """shard_batch -> sharded compress -> gather_streams composition:
    every frame's streams equal the host coder's."""
    h, w, b = 32, 64, 3
    ys = np.stack([_plane(rng, h, w) for _ in range(b)])
    us = np.stack([_plane(rng, h // 2, w // 2) for _ in range(b)])
    vs = np.stack([_plane(rng, h // 2, w // 2) for _ in range(b)])
    qts = [np.asarray(scalar.plane_qtable(i, 50), np.float32)
           for i in range(3)]
    frames = ss.compress_batch_sharded(mesh, (ys, us, vs), qts)
    assert len(frames) == b
    for f in range(b):
        want = _want_streams([ys[f], us[f], vs[f]], qts)
        for p in range(3):
            np.testing.assert_array_equal(
                frames[f][p][0].astype(np.int64), want[p][0])
            np.testing.assert_array_equal(frames[f][p][1], want[p][1])


def test_sharded_file_matches_host_file(mesh, tmp_path, rng):
    """A full .myyuv compressed via the mesh is byte-identical to the
    host-codec file (the strongest end-to-end sharding property)."""
    from myyuv_tpu import YUVImage
    from myyuv_tpu.engine import pipeline
    from myyuv_tpu.formats.yuv import FourccFormats

    h, w = 48, 64
    planes = _frame(rng, h, w)
    img = YUVImage.from_planes(FourccFormats.IYUV, planes, w, h)
    params = bytes([50, 50, 50])
    want = pipeline.compress_dct(img, params)

    qts = [np.asarray(scalar.plane_qtable(i, 50), np.float32)
           for i in range(3)]
    streams = ss.compress_frame_sharded(mesh, planes, qts)
    got = pipeline.streams_to_compressed(img, params, streams)
    f1, f2 = tmp_path / "host.myyuv", tmp_path / "mesh.myyuv"
    want.dump(f1)
    got.dump(f2)
    assert f1.read_bytes() == f2.read_bytes()
