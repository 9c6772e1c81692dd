"""K-frames-in-flight streaming drivers (engine/streaming.py).

CPU runs the codec kernels' XLA implementation through the same graphs as
the GPU; byte-equality against the synchronous frame API is the contract
(throughput on the card is bench.py's).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from myyuv_tpu.engine import batch as eb  # noqa: E402
from myyuv_tpu.engine import device_stream as ds  # noqa: E402
from myyuv_tpu.engine import streaming  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _frame(rng, h=64, w=128, hi=9):
    y = (rng.integers(0, hi, (h, w)) * 28).astype(np.uint8)
    u = rng.integers(100, 156, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(100, 156, (h // 2, w // 2)).astype(np.uint8)
    return y, u, v


def test_compress_stream_matches_frame_api(rng):
    planes = _frame(rng)
    qts = eb.plane_qtables([50] * 3)
    qts_np = [np.asarray(q) for q in qts]
    want = ds.compress_frame_to_streams(planes, qts_np)
    dev = tuple(jnp.asarray(p) for p in planes)
    # MID pull tier: the synthetic content is denser than golden q50,
    # and the test must exercise the streamed gather, not the fallback
    got = list(streaming.compress_stream([dev] * 3, qts, depth=1,
                                         capw8=ds.CAPW8_MID))
    assert len(got) == 3
    for streams in got:
        for (ws, wc), (gs, gc) in zip(want, streams):
            np.testing.assert_array_equal(ws, gs)
            np.testing.assert_array_equal(wc, gc)


def test_compress_stream_overflow_falls_back(rng):
    """A frame whose chunks exceed the cont=8 tier must still come out
    byte-identical (sync ladder retry inside the stream)."""
    planes = _frame(rng, h=32, w=64, hi=256)     # dense, q100
    planes = (rng.integers(0, 256, (32, 64)).astype(np.uint8),
              rng.integers(0, 256, (16, 32)).astype(np.uint8),
              rng.integers(0, 256, (16, 32)).astype(np.uint8))
    qts = eb.plane_qtables([100] * 3)
    qts_np = [np.asarray(q) for q in qts]
    want = ds.compress_frame_to_streams(planes, qts_np,
                                        cont0=ds.CONT_MID)
    dev = tuple(jnp.asarray(p) for p in planes)
    got = list(streaming.compress_stream([dev], qts))
    for (ws, wc), (gs, gc) in zip(want, got[0]):
        np.testing.assert_array_equal(ws, gs)
        np.testing.assert_array_equal(wc, gc)


def test_compact_stream_words_matches_repack(rng):
    """The pull-lean word gather + host squeeze must equal the dense
    pull path byte for byte."""
    from myyuv_tpu import native

    planes = _frame(rng, h=64, w=64)
    qts = eb.plane_qtables([50] * 3)
    cA, cC, sizes, total, ok = ds.compress_frame(
        *[jnp.asarray(p) for p in planes], *qts)
    sizes_np = np.asarray(sizes).astype(np.int32)
    want = ds._pull_packed_stream(cA, cC, sizes, sizes_np)
    # synthetic test content is denser than golden q50: the DEFAULT
    # tier (16 B/block avg) overflows here, MID covers it
    words, sizes_u8, okf = ds._compact_stream_words(
        cA, cC, sizes, ok, ds.CAPW8_MID)
    assert bool(np.asarray(okf))
    np.testing.assert_array_equal(np.asarray(sizes_u8), sizes_np)
    totw = int(((sizes_np.astype(np.int64) + 3) // 4).sum())
    got = native.repack_words(np.asarray(words)[:totw], sizes_np,
                              align=1)
    np.testing.assert_array_equal(got, want)


def test_compact_stream_words_overflow_flag(rng):
    """Streams larger than the capw8 tier flip ok (never truncate)."""
    planes = (rng.integers(0, 256, (32, 64)).astype(np.uint8),
              rng.integers(0, 256, (16, 32)).astype(np.uint8),
              rng.integers(0, 256, (16, 32)).astype(np.uint8))
    qts = eb.plane_qtables([100] * 3)
    cA, cC, sizes, total, ok = ds.compress_frame(
        *[jnp.asarray(p) for p in planes], *qts, cont=ds.CONT_ROOMY)
    _, _, okf = ds._compact_stream_words(cA, cC, sizes, ok,
                                         ds.CAPW8_DEFAULT)
    assert not bool(np.asarray(okf))
    words, su8, okf2 = ds._compact_stream_words(cA, cC, sizes, ok,
                                                ds.CAPW8_ROOMY)
    assert bool(np.asarray(okf2))


def test_roundtrip_stream_flags(rng):
    planes = _frame(rng)
    qts = eb.plane_qtables([50] * 3)
    dev = tuple(jnp.asarray(p) for p in planes)
    n = streaming.FLAG_CHUNK + 3          # exercise the tail chunk
    ok, totals, elapsed = streaming.roundtrip_stream([dev] * n, qts)
    assert ok.shape == (n,) and ok.all()
    _, _, _, total, _ = ds.compress_frame(*dev, *qts)
    assert (totals == int(total)).all()


def test_sustained_roundtrip_retries_ladder(rng):
    """q100 content overflows cont=8; the sustained driver must retry
    up the ladder and still report all-ok."""
    planes = (rng.integers(0, 256, (32, 64)).astype(np.uint8),
              rng.integers(0, 256, (16, 32)).astype(np.uint8),
              rng.integers(0, 256, (16, 32)).astype(np.uint8))
    qts = eb.plane_qtables([100] * 3)
    fps, ok_all, total, stats = streaming.sustained_roundtrip_fps(
        planes, qts, n_frames=4, k=2, windows=1)
    assert fps is not None and ok_all
    assert stats["retried_frames"] == 4
    assert len(stats["windows_fps"]) == 1


def test_ingest_and_preview_streams(rng):
    """The capture (BGRX -> IYUV -> compress) and playback (stream ->
    IYUV -> BGRX) chains: flags all-ok and totals identical to the
    synchronous frame API on the same converted content."""
    planes = _frame(rng)
    qts = eb.plane_qtables([50] * 3)
    h, w = planes[0].shape
    dev = tuple(jnp.asarray(p) for p in planes)
    px = streaming._convert_inv(*dev)
    ok, totals, _ = streaming.ingest_stream([px] * 2, qts)
    assert ok.shape == (2,) and ok.all()
    y2, u2, v2 = streaming._convert_fwd(px)
    _, _, _, total, okc = ds.compress_frame(y2, u2, v2, *qts)
    assert bool(np.asarray(okc))
    assert totals[0] == int(total) and totals[1] == int(total)
    cA, cC, sizes, _t, _o = ds.compress_frame(*dev, *qts)
    okp, _ = streaming.preview_stream((cA, cC, sizes), qts, h, w, 2)
    assert okp.shape == (2,) and okp.all()


def test_sustained_pipeline_fps_small(rng):
    planes = _frame(rng)
    qts = eb.plane_qtables([50] * 3)
    fi, fp, ok = streaming.sustained_pipeline_fps(planes, qts,
                                                  n_frames=16)
    assert ok and fi > 0 and fp > 0


def test_roundtrip_scan_matches_frame_api(rng):
    """K frames per dispatch via lax.scan: totals/ok identical to the
    per-frame executable."""
    planes = _frame(rng)
    qts = eb.plane_qtables([50] * 3)
    dev = tuple(jnp.asarray(p) for p in planes)
    _, _, _, total, ok = ds.compress_frame(*dev, *qts)
    k = 3
    ys = jnp.broadcast_to(dev[0], (k,) + dev[0].shape)
    us = jnp.broadcast_to(dev[1], (k,) + dev[1].shape)
    vs = jnp.broadcast_to(dev[2], (k,) + dev[2].shape)
    totals, oks = ds.roundtrip_scan(ys, us, vs, *qts)
    # the single-frame path must itself succeed, or the equality below
    # would pass trivially with both paths returning False
    assert bool(np.asarray(ok).all() if np.asarray(ok).ndim else ok)
    assert np.asarray(oks).all()
    assert (np.asarray(totals) == int(total)).all()


def test_sustained_scan_fps_small(rng):
    planes = _frame(rng)
    qts = eb.plane_qtables([50] * 3)
    fps, ok, total = streaming.sustained_scan_fps(planes, qts,
                                                  n_frames=6, k=3)
    assert ok and fps > 0 and total > 0
