"""Codec engine: the container-level compress/decompress backends.

The production compress/decompress path (reference call stacks §3.2/§3.3 of
SURVEY.md, compress_DCT_planar / decompress_DCT_planar, DCT.cpp:371-488)
with three backends:

* default: one batched, jitted transform per plane on the device
  (kernels/device.py, bit-exact vs the reference) with the native C++
  thread-parallel entropy codec (native/entropy.cpp) on the host,
  overlapping the three planes' device transforms via JAX async dispatch;
* ``"device"``: transform AND entropy on the device
  (engine/device_stream, the fused codec kernels), only compressed bytes
  cross the link;
* ``"cpu"``: the fused native C++ codec, no device at all.

The ragged chunk streams keep the exact on-disk layout
(formats/dct_stream.py). ``register_engine_codecs`` installs these as the
DCT codec for IYUV in the container registry;
``host_codec.register_host_codecs`` remains the NumPy-only fallback.
"""

from __future__ import annotations

import collections
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from .. import entropy
from ..formats import dct_stream, yuv
from ..kernels import constants, device
from ..runtime.errors import BitstreamError, GeometryError, MyYUVError
from . import host_codec

# times the "device" backend handed a frame to the default backend
# because its streams overflowed the device tiers ("compress" /
# "decompress"); a smoke run asserts these stay 0 for ordinary content
host_fallbacks = collections.Counter()


def _qtables(qualities: np.ndarray) -> List[np.ndarray]:
    return [constants.quality_scaled_qtable(constants.PLANE_Q50[i],
                                            int(qualities[i]))
            for i in range(3)]


def compress_dct(img: yuv.YUVImage, params: bytes,
                 precision: str = "exact",
                 entropy_backend: Optional[str] = None) -> yuv.YUVImage:
    """Planar DCT compression: device transform + native entropy."""
    if img.descriptor.group != yuv.FormatGroup.PLANAR:
        raise MyYUVError("Error compressing: YUV must be planar")
    if img.is_compressed():
        raise MyYUVError("Error already compressed")
    qualities = host_codec._check_quality(params)
    host_codec._check_geometry(img)
    planes = img.planes()
    qtables = _qtables(qualities)

    if entropy_backend == "device":
        # fully on-chip: transform + entropy on device, only compressed
        # bytes pulled back (engine.device_stream, one jit per geometry).
        # The encoder emits a static continuation-word tier (the cont
        # ladder 8/24/56); frames whose chunks overflow even the roomy
        # tier fall back to the host entropy stage instead of failing.
        from . import device_stream
        try:
            # quality picks the emission tier up front: high-q streams
            # carry >64 B chunks, so starting at the 128-byte tier skips
            # the default-tier attempt (and its compile) entirely
            cont0 = device_stream.cont_for_quality(int(qualities.max()))
            streams = [
                dct_stream.DCTPlaneStream(
                    sizes, np.frombuffer(content.tobytes(), np.uint8))
                for sizes, content in device_stream.compress_frame_to_streams(
                    planes, qtables, precision=precision, cont0=cont0)]
        except BitstreamError:
            host_fallbacks["compress"] += 1
            return compress_dct(img, params, precision=precision,
                                entropy_backend=None)
    elif entropy_backend == "cpu":
        # fused native CPU path: per-block DCT+quantize+Huffman in C++
        # threads, zero device traffic (native/entropy.cpp; bit-exact)
        from .. import native
        streams = [dct_stream.DCTPlaneStream(
            *native.compress_plane(planes[i], qtables[i]))
            for i in range(3)]
    else:
        # dispatch all three device transforms before pulling any result
        # back: JAX async dispatch keeps the device busy while the host
        # runs the native entropy stage.
        coeffs_dev = [
            device.dct_quantize_plane(jnp.asarray(planes[i]),
                                      jnp.asarray(qtables[i]),
                                      precision=precision)
            for i in range(3)
        ]
        streams = []
        for i in range(3):
            coeffs = np.asarray(coeffs_dev[i]).reshape(-1, 64)
            sizes, content = entropy.encode_blocks(coeffs,
                                                   backend=entropy_backend)
            streams.append(dct_stream.DCTPlaneStream(sizes, content))
    return _streams_to_image(img, params, streams)


def _streams_to_image(img: yuv.YUVImage, params: bytes,
                      streams: List[dct_stream.DCTPlaneStream]
                      ) -> yuv.YUVImage:
    payload = dct_stream.DCTStream(streams).serialize()
    header = yuv.YUVHeader(
        fourcc_format=img.header.fourcc_format,
        data_size=payload.size,
        compression=yuv.Compressions.DCT,
        compression_params_size=3,
        compression_params_pos=yuv.HEADER_SIZE,
        width=img.width, height=img.height,
        data_pos=yuv.HEADER_SIZE + 3)
    return yuv.YUVImage(header, np.frombuffer(params, np.uint8).copy(),
                        payload)


def streams_to_compressed(img: yuv.YUVImage, params: bytes,
                          plane_streams) -> yuv.YUVImage:
    """Assemble a compressed YUVImage from per-plane (sizes, content)
    pairs — the single-file assembly step for sharded/multi-host
    compression (engine.sharded_stream, parallel.distributed)."""
    host_codec._check_quality(params)
    streams = [dct_stream.DCTPlaneStream(
        np.asarray(s, np.uint8), np.asarray(c, np.uint8))
        for s, c in plane_streams]
    return _streams_to_image(img, params, streams)


def decompress_dct(img: yuv.YUVImage,
                   precision: str = "exact",
                   entropy_backend: Optional[str] = None) -> yuv.YUVImage:
    """Planar DCT decompression: native entropy + device inverse transform."""
    if img.descriptor.group != yuv.FormatGroup.PLANAR:
        raise MyYUVError("Error decompressing: YUV must be planar")
    qualities = host_codec._check_quality(img.compression_params.tobytes())
    host_codec._check_geometry(img)
    streams = dct_stream.DCTStream.parse(img.data)
    qtables = _qtables(qualities)

    for i in range(3):
        pw, ph = img.plane_shape(i)
        s = streams.planes[i]
        expect = (pw // 8) * (ph // 8)
        if s is None or s.num_blocks != expect:
            raise MyYUVError(
                f"plane {i}: expected {expect} blocks, stream has "
                f"{0 if s is None else s.num_blocks}")
    if entropy_backend == "device":
        # device capacity overflow (streams larger than the static lane
        # buffers) retries through the host entropy stage; genuinely
        # malformed streams still raise from the host decoder.
        from . import device_stream
        try:
            planes = list(device_stream.decompress_streams_to_frame(
                [(s.chunk_sizes, s.content) for s in streams.planes],
                qtables, img.height, img.width, precision=precision))
        except BitstreamError:
            host_fallbacks["decompress"] += 1
            return decompress_dct(img, precision=precision,
                                  entropy_backend=None)
    elif entropy_backend == "cpu":
        from .. import native
        planes = []
        for i in range(3):
            pw, ph = img.plane_shape(i)
            s = streams.planes[i]
            planes.append(native.decompress_plane(
                s.chunk_sizes, s.content, qtables[i], ph, pw))
    else:
        planes_dev = []
        for i in range(3):
            pw, ph = img.plane_shape(i)
            s = streams.planes[i]
            coeffs = entropy.decode_blocks(s.chunk_sizes, s.content,
                                           backend=entropy_backend)
            planes_dev.append(device.dequantize_idct_plane(
                jnp.asarray(coeffs.reshape(-1, 8, 8)),
                jnp.asarray(qtables[i]), ph, pw, precision=precision))
        planes = [np.asarray(p) for p in planes_dev]
    out = yuv.YUVImage.from_planes(
        img.header.fourcc_format, planes, img.width, img.height)
    return out


def bmp_to_iyuv(bmp) -> yuv.YUVImage:
    """BMP XRGB8888 -> IYUV on the device (myyuv_yuv.cpp:88-127 semantics)."""
    if bmp.header.bit_count != 32:
        raise MyYUVError("only 32-bit XRGB8888 BMP inputs are supported")
    pixels = bmp.pixels_topdown()
    y, u, v = device.bgrx_to_iyuv(jnp.asarray(pixels))
    return yuv.YUVImage.from_planes(
        yuv.FourccFormats.IYUV,
        [np.asarray(y), np.asarray(u), np.asarray(v)],
        bmp.true_width, bmp.true_height)


def iyuv_to_bgrx(img: yuv.YUVImage) -> np.ndarray:
    """IYUV image -> [H, W, 4] uint8 BGRX via the device preview kernel
    (frag_yuv.glsl math)."""
    if img.is_compressed():
        img = img.decompress()
    y, u, v = img.planes()[:3]
    return np.asarray(device.iyuv_to_bgrx(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v)))


def register_engine_codecs() -> None:
    """Install the device-accelerated paths in the codec registry."""
    yuv.BMP_TO_YUV[yuv.FourccFormats.IYUV] = bmp_to_iyuv
    yuv.register_codec(yuv.Compressions.DCT, yuv.FourccFormats.IYUV,
                       compress_dct, decompress_dct)
