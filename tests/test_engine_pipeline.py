"""Engine (device transforms + native entropy) end-to-end tests.

Differential strategy per SURVEY.md §4: (a) our decompress of the reference
CLI's compressed goldens matches the CLI's own decompress byte-for-byte;
(b) the reference CLI decompresses our compressed output to identical bytes;
(c) conversion and roundtrips match the host/scalar path bit-for-bit.
"""

import subprocess

import numpy as np
import pytest

pytest.importorskip("jax")

from myyuv_tpu import BMPImage, YUVImage  # noqa: E402
from myyuv_tpu.engine import host_codec, pipeline  # noqa: E402
from myyuv_tpu.formats import yuv as yuvmod  # noqa: E402


def test_engine_is_registered():
    assert yuvmod.COMPRESSORS[(yuvmod.Compressions.DCT,
                               yuvmod.FourccFormats.IYUV)] is pipeline.compress_dct


def test_bmp_to_iyuv_matches_host(images_dir):
    bmp = BMPImage.load(images_dir / "chef-with-trumpet.bmp")
    dev = pipeline.bmp_to_iyuv(bmp)
    host = host_codec.bmp_to_iyuv_host(bmp)
    np.testing.assert_array_equal(dev.data, host.data)


def test_bmp_to_iyuv_matches_golden(images_dir):
    bmp = BMPImage.load(images_dir / "chef-with-trumpet.bmp")
    golden = YUVImage.load(images_dir / "chef-with-trumpet.myyuv")
    dev = pipeline.bmp_to_iyuv(bmp)
    np.testing.assert_array_equal(dev.data, golden.data)


@pytest.mark.parametrize("q", [50, 90])
def test_decompress_reference_golden_bitexact(images_dir, oracle_cli,
                                              tmp_path, q):
    """(a): our decompress of their file == their decompress of their file."""
    src = images_dir / f"chef-with-trumpet-DCT-{q}.myyuv"
    ours = YUVImage.load(src).decompress()
    ref_out = tmp_path / "ref.myyuv"
    subprocess.run([str(oracle_cli), str(src), "-decompress",
                    "-o", str(ref_out)], check=True, capture_output=True)
    theirs = YUVImage.load(ref_out)
    np.testing.assert_array_equal(ours.data, theirs.data)


@pytest.mark.parametrize("q", [50, 90])
def test_reference_decodes_our_compressed(images_dir, oracle_cli,
                                          tmp_path, q):
    """(b): the reference CLI decodes our stream to our own pixels."""
    img = YUVImage.load(images_dir / "chef-with-trumpet.myyuv")
    comp = img.compress(yuvmod.Compressions.DCT, bytes([q, q, q]))
    ours_path = tmp_path / "ours.myyuv"
    comp.dump(ours_path)
    ref_out = tmp_path / "refdec.myyuv"
    subprocess.run([str(oracle_cli), str(ours_path), "-decompress",
                    "-o", str(ref_out)], check=True, capture_output=True)
    theirs = YUVImage.load(ref_out)
    ours_dec = comp.decompress()
    np.testing.assert_array_equal(ours_dec.data, theirs.data)


def test_engine_matches_host_roundtrip(images_dir):
    img = YUVImage.load(images_dir / "chef-with-trumpet.myyuv")
    params = bytes([50, 60, 70])
    dev_c = pipeline.compress_dct(img, params)
    host_c = host_codec.compress_dct_host(img, params)
    # identical quantized coefficients => identical decoded pixels; compare
    # decompressed output (encoded bytes may differ in tree tie-breaks)
    dev_d = pipeline.decompress_dct(dev_c)
    host_d = host_codec.decompress_dct_host(host_c)
    np.testing.assert_array_equal(dev_d.data, host_d.data)
    # native + oracle entropy agree byte-for-byte on sizes
    assert dev_c.data.size == host_c.data.size


def test_rgb_preview(images_dir):
    img = YUVImage.load(images_dir / "chef-with-trumpet.myyuv")
    rgb = pipeline.iyuv_to_bgrx(img)
    assert rgb.shape == (img.height, img.width, 4)
    assert rgb.dtype == np.uint8


def test_compress_size_parity_with_golden(images_dir):
    """Compression ratio parity: our q50 stream within 0.5% of the golden."""
    img = YUVImage.load(images_dir / "chef-with-trumpet.myyuv")
    comp = pipeline.compress_dct(img, bytes([50, 50, 50]))
    golden = YUVImage.load(images_dir / "chef-with-trumpet-DCT-50.myyuv")
    ratio = comp.data.size / golden.data.size
    assert abs(ratio - 1.0) < 0.005, ratio


def test_device_backend_falls_back_on_overflow(rng):
    """q=100 noise overflows CAP_PER_BLOCK; the device entropy backend must
    fall back to the host path, not fail."""
    h = w = 32
    planes = [rng.integers(0, 256, (h, w), np.uint8),
              rng.integers(0, 256, (h // 2, w // 2), np.uint8),
              rng.integers(0, 256, (h // 2, w // 2), np.uint8)]
    img = YUVImage.from_planes(yuvmod.FourccFormats.IYUV, planes, w, h)
    params = bytes([100, 100, 100])
    comp_dev = pipeline.compress_dct(img, params, entropy_backend="device")
    comp_host = pipeline.compress_dct(img, params)
    # identical compressed payload via the fallback's host entropy stage
    np.testing.assert_array_equal(comp_dev.data, comp_host.data)
    # decompress through the device backend falls back too (stream larger
    # than the static device capacity)
    dec_dev = pipeline.decompress_dct(comp_dev, entropy_backend="device")
    dec_host = pipeline.decompress_dct(comp_host)
    np.testing.assert_array_equal(dec_dev.data, dec_host.data)
