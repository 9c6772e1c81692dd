"""Quality sweep / RD statistics sanity."""

import numpy as np
import pytest

pytest.importorskip("jax")

from myyuv_tpu.engine import sweep  # noqa: E402


def test_rd_curve_monotone(images_dir):
    from myyuv_tpu import YUVImage
    img = YUVImage.load(images_dir / "chef-with-trumpet.myyuv")
    # crop to keep the test quick (multiple of 16 in both dims)
    y, u, v = img.planes()[:3]
    planes = [y[:128, :160], u[:64, :80], v[:64, :80]]
    pts = sweep.quality_sweep(planes, qualities=(10, 50, 90))
    psnr = [p["psnr_y_db"] for p in pts]
    size = [p["compressed_bytes"] for p in pts]
    assert psnr[0] < psnr[1] < psnr[2]   # higher q => better fidelity
    assert size[0] < size[1] < size[2]   # ...and larger streams
    assert all(p["entropy_bits_per_symbol"] > 0 for p in pts)


def test_rd_device_backend_rate_matches_host(images_dir):
    """The flagship-codec rate (entropy_backend='device') must equal the
    host coder's byte count exactly — the device entropy path produces
    byte-identical streams."""
    from myyuv_tpu import YUVImage
    img = YUVImage.load(images_dir / "chef-with-trumpet.myyuv")
    y, u, v = img.planes()[:3]
    planes = [y[:64, :128], u[:32, :64], v[:32, :64]]
    host = sweep.quality_sweep(planes, qualities=(50, 90))
    dev = sweep.quality_sweep(planes, qualities=(50, 90),
                              entropy_backend="device")
    for hp, dp in zip(host, dev):
        assert hp["compressed_bytes"] == dp["compressed_bytes"]
