"""The word-frame codec kernels (kernels/codec) against the host oracles.

Every CPU case runs BOTH implementations of the one kernel interface:
``"xla"`` (plain JAX) and ``"ffi"`` (native/codec_kernels.cu built by
g++ — the per-block arithmetic of native/block_codec.h that nvcc builds
for the GPU). The ``gpu`` cases run the nvcc build on the card.

Reference semantics: DCT.cpp:269-365 + Huffman.cpp:105-154,172-241 —
chunks byte-identical to the native host codec, decodable by the Python
oracle, pixels identical to kernels/scalar.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from myyuv_tpu import native  # noqa: E402
from myyuv_tpu.engine import device_stream as ds  # noqa: E402
from myyuv_tpu.entropy import decode_blocks_py, encode_blocks_py  # noqa: E402
from myyuv_tpu.kernels import codec, constants, scalar, words  # noqa: E402

IMPLS = ["xla", "ffi"]


def _qts(q):
    return [constants.quality_scaled_qtable(constants.PLANE_Q50[i], q)
            for i in range(3)]


def _natural(rng, h, w):
    """Smooth gradients + texture + a hard edge (small natural-ish frame)."""
    yy, xx = np.mgrid[0:h, 0:w]
    y = (128 + 50 * np.sin(xx / 5.0) * np.cos(yy / 4.0)
         + rng.normal(0, 4, (h, w)) + 40 * (xx > w // 2))
    yc, xc = np.mgrid[0:h // 2, 0:w // 2]
    u = 128 + 30 * np.sin(xc / 3.0) + rng.normal(0, 2, (h // 2, w // 2))
    v = 128 + 30 * np.cos(yc / 3.0) + rng.normal(0, 2, (h // 2, w // 2))
    return [np.clip(p, 0, 255).astype(np.uint8) for p in (y, u, v)]


def _noise(rng, h, w):
    return [rng.integers(0, 256, s).astype(np.uint8)
            for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]


def _frame(planes):
    """planes -> (xw, pids, n blocks) in the packed word layout."""
    y, u, v = planes
    h, w = y.shape
    ny, nc = (h // 8) * (w // 8), (h // 16) * (w // 16)
    xw = jnp.concatenate([words.pack_pixel_words(jnp.asarray(y)),
                          words.pack_pixel_words(
                              jnp.asarray(np.concatenate([u, v])))], axis=1)
    pad = (-xw.shape[1]) % codec.COLS
    xw = jnp.concatenate([xw, jnp.zeros((128, pad), jnp.int32)], axis=1)
    return xw, words.plane_pids(ny, nc, pad), ny + 2 * nc


def _encode(impl, planes, q, cont):
    xw, pids, n = _frame(planes)
    qts = words.stack_qtables(*_qts(q))
    out = jax.jit(lambda x, qq, p: codec.encode(x, qq, p, cont, impl=impl))(
        xw, qts, pids)
    return [np.asarray(o) for o in out], qts, pids, n


def _decode(impl, A, C, qts, pids):
    out = jax.jit(lambda a, c, qq, p: codec.decode(a, c, qq, p, impl=impl))(
        jnp.asarray(A), jnp.asarray(C), qts, pids)
    return [np.asarray(o) for o in out]


def _chunks(A, C, sizes, n):
    """Interchange -> per-block chunk bytes (list of bytes)."""
    w = np.concatenate([np.asarray(words.unpack_rows8(jnp.asarray(A))),
                        np.asarray(words.unpack_rows8(jnp.asarray(C)))],
                       axis=1)[:n]
    w = np.concatenate([w, np.zeros((n, 64 - w.shape[1]), np.int32)], 1)
    lanes = np.asarray(words.words_to_lanes(jnp.asarray(w)))
    return [lanes[i, :sizes[i]].tobytes() for i in range(n)]


def _native_streams(planes, q):
    """Per-plane (sizes, content) from the fused native host codec."""
    return [native.compress_plane(p, qt) for p, qt in zip(planes, _qts(q))]


def _native_chunks(planes, q):
    out = []
    for sizes, content in _native_streams(planes, q):
        offs = np.concatenate([[0], np.cumsum(sizes.astype(np.int64))])
        out += [content[offs[i]:offs[i + 1]].tobytes()
                for i in range(sizes.size)]
    return out


def _scalar_coeffs(planes, q):
    return np.concatenate([
        scalar.dct_quantize_blocks(scalar.plane_to_blocks(p), qt)
        .reshape(-1, 64) for p, qt in zip(planes, _qts(q))]).astype(np.int16)


def _scalar_pixels(planes, q):
    """Scalar-oracle roundtrip -> packed word frame columns [128, n/8]."""
    rec = []
    for p, qt in zip(planes, _qts(q)):
        co = scalar.dct_quantize_blocks(scalar.plane_to_blocks(p), qt)
        rec.append(scalar.blocks_to_plane(
            scalar.dequantize_idct_blocks(co, qt), *p.shape))
    xw, _, n = _frame(rec)
    return np.asarray(xw)[:, :n // 8]


def _interchange_from_streams(streams, cont):
    """Native byte streams -> dense (A, C) interchange (the upload path)."""
    sizes = np.concatenate([s.astype(np.int32) for s, _ in streams])
    content = np.concatenate([c for _, c in streams])
    a, b = native.expand_split(content, sizes)
    return a, ds._dense_c_np(b, sizes, cont), sizes


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("q", [50, 90])
def test_chunks_byte_identical_to_native(impl, q):
    planes = _natural(np.random.default_rng(q), 64, 64)
    (A, C, sizes, ok), _, _, n = _encode(impl, planes, q, ds.CONT_ROOMY)
    assert ok[:n].all()
    want = _native_chunks(planes, q)
    np.testing.assert_array_equal(sizes[:n], [len(c) for c in want])
    assert _chunks(A, C, sizes, n) == want


@pytest.mark.parametrize("impl", IMPLS)
def test_reference_decodes_kernel_chunks(impl):
    """The per-block Python oracle (entropy/reference) decodes the kernel's
    chunks to the scalar oracle's coefficients, with its optimal sizes."""
    planes = _natural(np.random.default_rng(1), 32, 64)
    planes[0][:8, :8] = 128        # all-zero block: single 0 symbol
    planes[0][:8, 8:16] = 131      # DC-only block: single-symbol message
    (A, C, sizes, ok), _, _, n = _encode(impl, planes, 75, ds.CONT_ROOMY)
    assert ok[:n].all()
    chunks = _chunks(A, C, sizes, n)
    content = np.frombuffer(b"".join(chunks), np.uint8)
    coeffs = _scalar_coeffs(planes, 75)
    np.testing.assert_array_equal(
        decode_blocks_py(sizes[:n].astype(np.uint8), content), coeffs)
    ref_sizes, _ = encode_blocks_py(coeffs)
    np.testing.assert_array_equal(sizes[:n], ref_sizes)


@pytest.mark.parametrize("impl", IMPLS)
def test_a_region_is_decoder_w0_layout(impl):
    """Region A holds word w of block 8c + r at row 8w + r: exactly the
    packed W0 window that native.expand_split builds from the bytes."""
    planes = _natural(np.random.default_rng(2), 32, 64)
    (A, C, sizes, ok), _, _, n = _encode(impl, planes, 50, ds.CONT_DEFAULT)
    a_host, _ = native.expand_split(
        np.frombuffer(b"".join(_chunks(A, C, sizes, n)), np.uint8),
        sizes[:n])
    np.testing.assert_array_equal(A[:, :n // 8], a_host[:, :n // 8])


@pytest.mark.parametrize("impl", IMPLS)
def test_small_tables_and_extremes(impl):
    """Flat blocks (one or two distinct symbols) and saturated blocks
    (DC at the format's extremes at q100) stay byte-identical."""
    h, w = 32, 64
    y = np.full((h, w), 128, np.uint8)
    y[:, 8:16] = 0                 # DC -1024 at q100
    y[:, 16:24] = 255              # DC +1016
    y[8:16, 24:32] = 129           # tiny DC
    y[16:24, 32:40] = np.arange(8, dtype=np.uint8)[None, :] + 120
    u = np.full((h // 2, w // 2), 128, np.uint8)
    v = u.copy()
    v[:8, :8] = 200
    planes = [y, u, v]
    for q in (50, 100):
        (A, C, sizes, ok), _, _, n = _encode(impl, planes, q,
                                             ds.CONT_ROOMY)
        assert ok[:n].all()
        assert _chunks(A, C, sizes, n) == _native_chunks(planes, q)


@pytest.mark.parametrize("impl", IMPLS)
def test_cont8_tier_flags_oversize(impl):
    """cont=8 (64-byte tier): chunks over 64 bytes flip ok with their exact
    size; the others are complete and byte-identical."""
    rng = np.random.default_rng(4)
    planes = _natural(rng, 32, 64)
    planes[0][8:16, 8:16] = rng.integers(0, 256, (8, 8))
    (A, C, sizes, ok), _, _, n = _encode(impl, planes, 100, ds.CONT_DEFAULT)
    want = _native_chunks(planes, 100)
    np.testing.assert_array_equal(sizes[:n], [len(c) for c in want])
    big = sizes[:n] > 64
    assert big.any() and not ok[:n][big].any()
    assert ok[:n][~big].all()
    got = _chunks(A, C, sizes, n)
    assert [g for g, b in zip(got, big) if not b] == \
        [c for c, b in zip(want, big) if not b]


@pytest.mark.parametrize("impl", IMPLS)
def test_cont24_tier_roundtrip(impl):
    """cont=24 (128-byte tier): chunks between 64 and 128 bytes encode
    and decode straight back through the cw=32 window."""
    planes = _noise(np.random.default_rng(5), 32, 64)
    (A, C, sizes, ok), qts, pids, n = _encode(impl, planes, 80, ds.CONT_MID)
    assert ok[:n].all()
    assert (sizes[:n] > 64).any() and (sizes[:n] <= 128).all()
    assert C.shape[0] == 8 * ds.CONT_MID
    xw, dok = _decode(impl, A, C, qts, pids)
    assert dok[:n].all()
    np.testing.assert_array_equal(xw[:, :n // 8], _scalar_pixels(planes, 80))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("q", [10, 95])
def test_decodes_native_encoded(impl, q):
    """Interchange built from native host streams (the upload path)
    decodes to the scalar oracle's pixels."""
    planes = _natural(np.random.default_rng(q), 32, 64)
    streams = _native_streams(planes, q)
    a, c, sizes = _interchange_from_streams(streams, ds.CONT_ROOMY)
    _, pids, n = _frame(planes)
    qts = words.stack_qtables(*_qts(q))
    xw, ok = _decode(impl, a, c, qts, pids[:a.shape[1]])
    assert ok[:n].all()
    np.testing.assert_array_equal(xw[:, :n // 8], _scalar_pixels(planes, q))


@pytest.mark.parametrize("impl", IMPLS)
def test_corrupt_chunk_flagged(impl):
    """A stomped tree header flags exactly its block; the rest decode."""
    planes = _natural(np.random.default_rng(6), 32, 64)
    (A, C, sizes, ok), qts, pids, n = _encode(impl, planes, 50,
                                              ds.CONT_DEFAULT)
    bad = A.copy()
    bad[0 * 8 + 3, 1] ^= 0x00FFFF00     # block 8*1 + 3: header word
    _, dok = _decode(impl, bad, C, qts, pids)
    assert not dok[11]
    assert np.delete(dok[:n], 11).all()


def _oversized_tree_words():
    """Stream-space words of a chunk whose tree declares 96 symbols (> the
    64 maximum): the reference decoder throws on it."""
    chunk = bytearray((0).to_bytes(2, "little"))    # enc_bits = 0
    tree = (bytes([((8 - 1) << 5) | 31]) + bytes(44)) * 3
    chunk.append(len(tree))
    chunk += tree
    lane = np.zeros((1, 256), np.uint8)
    lane[0, :len(chunk)] = np.frombuffer(bytes(chunk), np.uint8)
    return np.asarray(words.lanes_to_words(jnp.asarray(lane)))[0]


@pytest.mark.parametrize("impl", IMPLS)
def test_oversized_tree_flagged(impl):
    planes = _natural(np.random.default_rng(7), 32, 64)
    (A, C, sizes, ok), qts, pids, n = _encode(impl, planes, 50,
                                              ds.CONT_ROOMY)
    A, C = A.copy(), C.copy()
    wd = _oversized_tree_words()
    for w in range(8):                  # block 8*2 + 4
        A[8 * w + 4, 2] = wd[w]
    for w in range(56):
        C[8 * w + 4, 2] = wd[8 + w]
    _, dok = _decode(impl, A, C, qts, pids)
    assert not dok[20]
    assert np.delete(dok[:n], 20).all()


@pytest.mark.parametrize("impl", IMPLS)
def test_transform_matches_scalar_oracle(impl):
    """Forward: the chunks carry kernels/scalar's quantized coefficients;
    inverse: decoded pixels equal kernels/scalar's roundtrip — at the
    quality extremes."""
    planes = _noise(np.random.default_rng(8), 32, 64)
    for q in (1, 100):
        (A, C, sizes, ok), qts, pids, n = _encode(impl, planes, q,
                                                  ds.CONT_ROOMY)
        content = np.frombuffer(b"".join(_chunks(A, C, sizes, n)), np.uint8)
        np.testing.assert_array_equal(
            native.decode_blocks(sizes[:n].astype(np.uint8), content),
            _scalar_coeffs(planes, q))
        xw, dok = _decode(impl, A, C, qts, pids)
        assert dok[:n].all()
        np.testing.assert_array_equal(xw[:, :n // 8],
                                      _scalar_pixels(planes, q))


@pytest.mark.parametrize("impl", IMPLS)
def test_ragged_column_count(impl):
    """The kernels take any column count (no thread-block padding) and
    preserve it: 13 columns, the last thread block ragged."""
    planes = _natural(np.random.default_rng(9), 16, 256)  # 12 columns
    xw, pids, n = _frame(planes)
    xw, pids = xw[:, :13], pids[:13]
    qts = words.stack_qtables(*_qts(50))
    A, C, sizes, ok = codec.encode(xw, qts, pids, 8, impl=impl)
    assert A.shape == (64, 13) and C.shape == (64, 13)
    assert sizes.shape == (104,) and ok.shape == (104,)
    rxw, dok = codec.decode(A, C, qts, pids, impl=impl)
    assert rxw.shape == (128, 13) and dok.shape == (104,)
    assert np.asarray(ok).all() and np.asarray(dok).all()
    np.testing.assert_array_equal(np.asarray(rxw)[:, :n // 8],
                                  _scalar_pixels(planes, 50))


# ---------------------------------------------------------------------------
# the selector and the FFI wrapper
# ---------------------------------------------------------------------------


def test_default_impl_follows_platform(monkeypatch):
    from myyuv_tpu.runtime import backend
    monkeypatch.setattr(backend, "platform", lambda: "cpu")
    assert codec.default_impl() == "xla"
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert codec.default_impl() == "ffi"


@pytest.mark.parametrize("name,want", [("cpu", "cpu"), ("gpu", "gpu"),
                                       ("cuda", "gpu"), ("metal", None)])
def test_backend_selector(monkeypatch, name, want):
    from myyuv_tpu.runtime import backend
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    if want is None:
        with pytest.raises(RuntimeError, match="unsupported JAX backend"):
            backend.platform()
    else:
        assert backend.platform() == want


def test_gpu_build_failure_raises(monkeypatch):
    """On the GPU a missing or unbuildable kernel library raises; the
    codec never falls back to the XLA implementation."""
    from myyuv_tpu.runtime import backend

    def broken(platform):
        raise RuntimeError(f"building libmyyuv_codec_{platform}.so failed")

    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    monkeypatch.setattr(native, "build_codec_kernels", broken)
    monkeypatch.setattr(codec, "_REGISTERED", set())
    xw, pids, _ = _frame(_natural(np.random.default_rng(0), 16, 128))
    with pytest.raises(RuntimeError, match="libmyyuv_codec_gpu"):
        codec.encode(xw, words.stack_qtables(*_qts(50)), pids, 8)


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    """build_codec_kernels("gpu") without a CUDA compiler raises."""
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "nvcc", lambda: str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="libmyyuv_codec_gpu"):
        native.build_codec_kernels("gpu")


def test_wrapper_rejects_bad_arguments():
    xw, pids, _ = _frame(_natural(np.random.default_rng(0), 16, 128))
    qts = words.stack_qtables(*_qts(50))
    with pytest.raises(ValueError, match="unknown codec implementation"):
        codec.encode(xw, qts, pids, 8, impl="pallas")
    with pytest.raises(ValueError, match="lane columns"):
        codec.encode(xw, qts, pids[:-1], 8, impl="ffi")
    with pytest.raises(ValueError, match="bad regions"):
        codec.decode(jnp.zeros((64, 32), jnp.int32),
                     jnp.zeros((60, 32), jnp.int32), qts, pids, impl="ffi")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def gpu():
    from myyuv_tpu.runtime import backend
    try:
        if backend.platform() == "gpu":
            return
    except RuntimeError:
        pass
    pytest.skip("needs an NVIDIA GPU (MYYUV_TEST_GPU=1 pytest -m gpu)")


@pytest.mark.gpu
@pytest.mark.parametrize("q", [50, 90])
def test_gpu_kernels_match_xla_and_native(gpu, q):
    planes = _natural(np.random.default_rng(q), 256, 512)
    assert codec.default_impl() == "ffi"
    got = {impl: _encode(impl, planes, q, ds.CONT_ROOMY) for impl in IMPLS}
    (A, C, sizes, ok), qts, pids, n = got["ffi"]
    for x, y in zip(got["ffi"][0], got["xla"][0]):
        np.testing.assert_array_equal(x, y)
    assert _chunks(A, C, sizes, n) == _native_chunks(planes, q)
    xw, dok = _decode("ffi", A, C, qts, pids)
    xw_x, dok_x = _decode("xla", A, C, qts, pids)
    assert dok[:n].all() and np.array_equal(xw, xw_x)
    np.testing.assert_array_equal(xw[:, :n // 8], _scalar_pixels(planes, q))


@pytest.mark.gpu
def test_gpu_transforms_exact(gpu):
    """kernels/device's runtime-zero FMA guard survives XLA's GPU backend."""
    from myyuv_tpu.kernels import device as kdev
    planes = _noise(np.random.default_rng(3), 256, 512)
    for q in (10, 90):
        qt = _qts(q)[0]
        blocks = scalar.plane_to_blocks(planes[0])
        co = np.asarray(kdev.dct_quantize(jnp.asarray(blocks),
                                          jnp.asarray(qt)))
        np.testing.assert_array_equal(co, scalar.dct_quantize_blocks(
            blocks, qt))
        np.testing.assert_array_equal(
            np.asarray(kdev.dequantize_idct(jnp.asarray(co),
                                            jnp.asarray(qt))),
            scalar.dequantize_idct_blocks(co, qt))
