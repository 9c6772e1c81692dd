"""Word-contract frame format (engine/word_frame): the packed i32
device-resident frame representation.

Runs the codec kernels' CPU implementation on small frames so the full
contract — pack/unpack inversion, interchange byte-equality with the
plane-contract compress, roundtrip pixel-exactness vs the scalar
oracle, scan batching, column sharding — is covered on CPU."""

import jax.numpy as jnp
import numpy as np
import pytest

from myyuv_tpu.engine import batch as eb
from myyuv_tpu.engine import device_stream as ds
from myyuv_tpu.engine import word_frame as wf
from myyuv_tpu.kernels import scalar

H, W = 32, 64


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _frame(rng):
    base = np.add.outer(np.arange(H) * 3, np.arange(W) * 2) % 200
    y = (base + rng.integers(0, 40, (H, W))).astype(np.uint8)
    u = rng.integers(90, 170, (H // 2, W // 2)).astype(np.uint8)
    v = rng.integers(90, 170, (H // 2, W // 2)).astype(np.uint8)
    return y, u, v


def _scalar_roundtrip(planes, q=50):
    out = []
    for i, p in enumerate(planes):
        qt = scalar.plane_qtable(i, q)
        co = scalar.dct_quantize_blocks(scalar.plane_to_blocks(p), qt)
        out.append(scalar.blocks_to_plane(
            scalar.dequantize_idct_blocks(co, qt), *p.shape))
    return out


def test_pack_unpack_inverse(rng):
    y, u, v = _frame(rng)
    xw = wf.pack_frame(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
    ny8, nc8, ntp = wf.frame_cols(H, W)
    assert xw.shape == (128, ntp)
    ry, ru, rv = wf.unpack_frame(xw, H, W)
    assert np.array_equal(np.asarray(ry), y)
    assert np.array_equal(np.asarray(ru), u)
    assert np.array_equal(np.asarray(rv), v)


def test_compress_words_matches_plane_contract(rng):
    """The word-contract interchange must be byte-identical to the
    plane-contract compress on the same pixels."""
    y, u, v = _frame(rng)
    qts = eb.plane_qtables([50] * 3)
    xw = wf.pack_frame(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
    A, C, sizes, total, ok = wf.compress_words(
        xw, *qts, h=H, w=W)
    assert bool(ok)
    cA, cC, csizes, ctotal, cok = ds.compress_frame(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), *qts)
    assert bool(cok)
    assert int(total) == int(ctotal)
    assert np.array_equal(np.asarray(sizes), np.asarray(csizes))
    n8 = (np.asarray(csizes).size + 7) // 8
    assert np.array_equal(np.asarray(A)[:, :n8], np.asarray(cA)[:, :n8])
    # live continuation rows agree (pad-block columns may differ)
    assert np.array_equal(np.asarray(C)[:, :n8], np.asarray(cC)[:, :n8])


def test_roundtrip_words_pixel_exact(rng):
    y, u, v = _frame(rng)
    qts = eb.plane_qtables([50] * 3)
    xw = wf.pack_frame(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
    rxw, total, ok = wf.roundtrip_words(xw, *qts, h=H, w=W)
    assert bool(ok) and rxw.shape == xw.shape
    ry, ru, rv = wf.unpack_frame(rxw, H, W)
    wy, wu, wv = _scalar_roundtrip([y, u, v])
    assert np.array_equal(np.asarray(ry), wy)
    assert np.array_equal(np.asarray(ru), wu)
    assert np.array_equal(np.asarray(rv), wv)


def test_roundtrip_words_scan(rng):
    y, u, v = _frame(rng)
    qts = eb.plane_qtables([50] * 3)
    xw = wf.pack_frame(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
    _, total, ok = wf.roundtrip_words(xw, *qts, h=H, w=W)
    assert bool(ok)
    xws = jnp.broadcast_to(xw, (3,) + xw.shape)
    totals, oks = wf.roundtrip_words_scan(xws, *qts, h=H, w=W)
    assert np.asarray(oks).all()
    assert (np.asarray(totals) == int(total)).all()


def test_word_conversions_match_plane_path(rng):
    """bgrx_to_frame == pack_frame(bgrx_to_iyuv(px)) and frame_to_bgrx
    == iyuv_to_bgrx(unpack_frame(xw)): the fused word-contract
    conversions against the plane-contract chain.

    CPU-jit caveat: CPU XLA may fold the runtime-zero FMA guard and
    contract the conversion mul+add chains, so two differently-fused
    modules can disagree by 1 ulp exactly at trunc/rint boundaries.
    The content below avoids pixels within 1e-3 of those boundaries
    (float64 model), so this test checks the WIRING deterministically;
    bit-exactness of the conversions on the GPU is asserted by
    chip_smoke.py."""
    from myyuv_tpu.kernels import device as kdev
    bgrx = rng.integers(0, 256, (H, W, 4), np.uint8)
    bgrx[..., 3] = 0
    b64, g64, r64 = [bgrx[..., i].astype(np.float64) for i in range(3)]
    yf = 0.299 * r64 + 0.587 * g64 + 0.114 * b64
    cb = (b64 - yf) * 0.564
    cr = (r64 - yf) * 0.713
    risky = np.zeros(yf.shape, bool)
    for x in (yf, cb, cr):
        risky |= np.abs(x - np.round(x)) < 1e-3
    bgrx[risky] = 0                       # black pixels are boundary-safe
    bdev = jnp.asarray(bgrx)
    xw = wf.bgrx_to_frame(bdev)
    y, u, v = kdev.bgrx_to_iyuv(bdev)
    want = wf.pack_frame(y, u, v)
    assert np.array_equal(np.asarray(xw), np.asarray(want))
    # preview direction: rint boundaries live at x.5 — risky pixels get
    # neutral chroma (vv = uu = 0, products exactly zero)
    y2, u2, v2 = _frame(rng)
    yr = y2.astype(np.float64)
    uu = np.repeat(np.repeat(u2, 2, 0), 2, 1).astype(np.float64) - 128
    vv = np.repeat(np.repeat(v2, 2, 0), 2, 1).astype(np.float64) - 128
    est = np.stack([yr + 1.403 * vv, yr - 0.714 * vv - 0.344 * uu,
                    yr + 1.773 * uu])
    risky2 = (np.abs(est - np.floor(est) - 0.5) < 1e-3).any(axis=0)
    risky_c = risky2.reshape(H // 2, 2, W // 2, 2).any(axis=(1, 3))
    u2[risky_c] = 128
    v2[risky_c] = 128
    fr = wf.pack_frame(jnp.asarray(y2), jnp.asarray(u2),
                       jnp.asarray(v2))
    got = wf.frame_to_bgrx(fr, H, W)
    wantpx = kdev.iyuv_to_bgrx(jnp.asarray(y2), jnp.asarray(u2),
                               jnp.asarray(v2))
    assert np.array_equal(np.asarray(got), np.asarray(wantpx))


def test_sharded_word_codec_byte_identical(rng):
    """Column-sharding the word frame over an 8-device mesh: per-device
    fused kernels, assembly = concatenation — interchange and
    roundtrip byte/pixel-identical to the single-device word path."""
    import jax
    from myyuv_tpu.parallel import mesh as meshlib

    devs = jax.devices("cpu")[:8]
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = meshlib.make_mesh((2, 4), devs)
    y, u, v = _frame(rng)
    qts = eb.plane_qtables([50] * 3)
    xw = wf.pack_frame(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
    xws = wf.pad_frame_cols(xw, 8)
    A, C, sizes, total, ok = wf.compress_words_sharded(
        mesh, xws, *qts, h=H, w=W)
    assert bool(ok)
    rA, rC, rsizes, rtotal, rok = wf.compress_words(
        xw, *qts, h=H, w=W)
    assert bool(rok) and int(total) == int(rtotal)
    assert np.array_equal(np.asarray(sizes), np.asarray(rsizes))
    n8 = (np.asarray(rsizes).size + 7) // 8
    assert np.array_equal(np.asarray(A)[:, :n8], np.asarray(rA)[:, :n8])
    assert np.array_equal(np.asarray(C)[:, :n8], np.asarray(rC)[:, :n8])
    rxw, dok = wf.decompress_words_sharded(
        mesh, A, C, sizes, *qts, h=H, w=W)
    assert bool(dok)
    ry, ru, rv = wf.unpack_frame(rxw, H, W)
    wy, wu, wv = _scalar_roundtrip([y, u, v])
    assert np.array_equal(np.asarray(ry), wy)
    assert np.array_equal(np.asarray(ru), wu)
    assert np.array_equal(np.asarray(rv), wv)


def test_ingest_preview_single_dispatch_match(rng):
    """The one-executable ingest/preview entries equal their two-step
    chains exactly."""
    from myyuv_tpu.kernels import device as kdev
    bgrx = rng.integers(0, 256, (H, W, 4), np.uint8)
    bgrx[..., 3] = 0
    bdev = jnp.asarray(bgrx)
    qts = eb.plane_qtables([50] * 3)
    A1, C1, s1, t1, ok1 = wf.ingest_frame(bdev, *qts, h=H, w=W)
    xw = wf.bgrx_to_frame(bdev)
    A2, C2, s2, t2, ok2 = wf.compress_words(xw, *qts, h=H, w=W)
    assert bool(ok1) == bool(ok2) and int(t1) == int(t2)
    assert np.array_equal(np.asarray(s1), np.asarray(s2))
    assert np.array_equal(np.asarray(A1), np.asarray(A2))
    assert np.array_equal(np.asarray(C1), np.asarray(C2))
    px1, dok1 = wf.preview_frame(A1, C1, s1, *qts, h=H, w=W)
    fr, dok2 = wf.decompress_words(A1, C1, s1, *qts, h=H, w=W)
    px2 = wf.frame_to_bgrx(fr, H, W)
    assert bool(dok1) and bool(dok2)
    assert np.array_equal(np.asarray(px1), np.asarray(px2))


def test_decompress_words_corrupt_stream_flags(rng):
    """Corrupt interchange words must flip the word-contract decoder's
    ok flag (failure-detection parity with the plane contract), never
    produce silently wrong pixels."""
    y, u, v = _frame(rng)
    qts = eb.plane_qtables([50] * 3)
    xw = wf.pack_frame(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
    A, C, sizes, _, ok = wf.compress_words(
        xw, *qts, h=H, w=W)
    assert bool(ok)
    # stomp chunk 0's tree section: an impossible code-length group
    badA = np.asarray(A).copy()
    badA[0, 0] = badA[0, 0] ^ 0x00FFFF00
    _, dok = wf.decompress_words(jnp.asarray(badA), C, sizes, *qts,
                                 h=H, w=W)
    assert not bool(dok)
    # oversized sizes (beyond the window) must also flag
    bad_sizes = np.asarray(sizes).copy()
    bad_sizes[0] = 255
    _, dok2 = wf.decompress_words(A, C, jnp.asarray(bad_sizes), *qts,
                                  h=H, w=W)
    assert not bool(dok2)


def test_compress_words_overflow_flags(rng):
    """Noise at q100 overflows the default tier: ok must go False, and
    the roomy tier must recover byte-identical streams."""
    y = rng.integers(0, 256, (H, W)).astype(np.uint8)
    u = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    qts = eb.plane_qtables([100] * 3)
    xw = wf.pack_frame(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
    _, _, _, _, ok = wf.compress_words(
        xw, *qts, h=H, w=W)
    assert not bool(ok)
    A, C, sizes, total, ok2 = wf.compress_words(
        xw, *qts, h=H, w=W, cont=ds.CONT_ROOMY)
    assert bool(ok2)
    rxw, dok = wf.decompress_words(A, C, sizes, *qts, h=H, w=W)
    assert bool(dok)
    ry, ru, rv = wf.unpack_frame(rxw, H, W)
    wy, wu, wv = _scalar_roundtrip([y, u, v], q=100)
    for g, wv_ in ((ry, wy), (ru, wu), (rv, wv)):
        assert np.array_equal(np.asarray(g), wv_)


@pytest.mark.parametrize("impl", ["xla", "ffi"])
def test_shard_alignment_four_devices(rng, impl):
    """4-device column sharding at a geometry whose slabs (32 columns
    each) are not a multiple of any 128/512-column tile: pad_frame_cols
    aligns every slab to the kernels' one block width (codec.COLS), the
    sharded roundtrip keeps the frame's shape, and the assembled pixels
    equal the single-device result."""
    import jax
    from myyuv_tpu.kernels import codec
    from myyuv_tpu.parallel import mesh as meshlib

    devs = jax.devices("cpu")[:4]
    if len(devs) < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = meshlib.make_mesh((1, 4), devs)
    y, u, v = _frame(rng)
    qts = eb.plane_qtables([50] * 3)
    xw = wf.pack_frame(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
    xws = wf.pad_frame_cols(xw, 4)
    assert xws.shape[1] == 4 * codec.COLS
    A, C, sizes, total, ok = wf.compress_words_sharded(
        mesh, xws, *qts, h=H, w=W, impl=impl)
    assert bool(ok) and A.shape == (64, xws.shape[1])
    rA, rC, rsizes, rtotal, rok = wf.compress_words(xw, *qts, h=H, w=W,
                                                    impl=impl)
    n8 = rA.shape[1]
    assert np.array_equal(np.asarray(A)[:, :n8], np.asarray(rA))
    assert np.array_equal(np.asarray(sizes), np.asarray(rsizes))
    rxw, dok = wf.decompress_words_sharded(mesh, A, C, sizes, *qts, h=H,
                                           w=W, impl=impl)
    assert bool(dok) and rxw.shape == xws.shape
    want, _ = wf.decompress_words(rA, rC, rsizes, *qts, h=H, w=W,
                                  impl=impl)
    for a, b in zip(wf.unpack_frame(rxw, H, W), wf.unpack_frame(want, H, W)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
