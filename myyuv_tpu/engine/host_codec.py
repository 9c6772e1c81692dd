"""Host (NumPy) DCT codec pipeline: the CPU fallback + validation path.

Mirrors compress_DCT_planar / decompress_DCT_planar (DCT.cpp:371-488) using
the scalar kernels and the per-block entropy oracle. The JAX engine
(engine.pipeline) supersedes this where JAX is available; both register
through the same codec registry so the container API dispatches
identically.
"""

from __future__ import annotations

import numpy as np

from ..entropy import reference as entropy_ref
from ..formats import dct_stream, yuv
from ..kernels import scalar
from ..runtime.errors import GeometryError, MyYUVError


def _check_geometry(img: yuv.YUVImage) -> None:
    fw, fh = img.descriptor.resolution_fraction
    if img.width % (8 * fw) != 0:
        raise GeometryError(f"width must be divisible by {8 * fw}")
    if img.height % (8 * fh) != 0:
        raise GeometryError(f"height must be divisible by {8 * fh}")


def _check_quality(params: bytes) -> np.ndarray:
    if len(params) != 3:
        raise MyYUVError(
            "Error compression: incorrect parameters count. 3 parameters required")
    q = np.frombuffer(params, np.uint8)
    if ((q < 1) | (q > 100)).any():
        raise MyYUVError("Level of quality must be between 1 and 100")
    return q


def compress_dct_host(img: yuv.YUVImage, params: bytes) -> yuv.YUVImage:
    """Planar DCT compression on the host (DCT.cpp:371-430 semantics)."""
    if img.descriptor.group != yuv.FormatGroup.PLANAR:
        raise MyYUVError("Error compressing: YUV must be planar")
    if img.is_compressed():
        raise MyYUVError("Error already compressed")
    qualities = _check_quality(params)
    _check_geometry(img)
    planes = img.planes()
    streams = []
    for i in range(3):
        qtab = scalar.plane_qtable(i, int(qualities[i]))
        blocks = scalar.plane_to_blocks(planes[i])
        coeffs = scalar.dct_quantize_blocks(blocks, qtab)
        chunks = [entropy_ref.encode_block(coeffs[k].reshape(64))
                  for k in range(coeffs.shape[0])]
        sizes = np.array([len(c) for c in chunks], np.uint8)
        content = np.frombuffer(b"".join(chunks), np.uint8)
        streams.append(dct_stream.DCTPlaneStream(sizes, content))
    payload = dct_stream.DCTStream(streams).serialize()

    header = yuv.YUVHeader(
        fourcc_format=img.header.fourcc_format,
        data_size=payload.size,
        compression=yuv.Compressions.DCT,
        compression_params_size=3,
        compression_params_pos=yuv.HEADER_SIZE,
        width=img.width, height=img.height,
        data_pos=yuv.HEADER_SIZE + 3)
    return yuv.YUVImage(header, np.frombuffer(params, np.uint8).copy(), payload)


def decompress_dct_host(img: yuv.YUVImage) -> yuv.YUVImage:
    """Planar DCT decompression on the host (DCT.cpp:432-488 semantics)."""
    if img.descriptor.group != yuv.FormatGroup.PLANAR:
        raise MyYUVError("Error decompressing: YUV must be planar")
    qualities = _check_quality(img.compression_params.tobytes())
    _check_geometry(img)
    streams = dct_stream.DCTStream.parse(img.data)
    planes = []
    for i in range(3):
        pw, ph = _plane_wh(img, i)
        qtab = scalar.plane_qtable(i, int(qualities[i]))
        stream = streams.planes[i]
        pos = stream.content_pos()
        content = stream.content.tobytes()
        coeffs = np.stack([
            entropy_ref.decode_block(
                content[pos[k]: pos[k] + stream.chunk_sizes[k]])
            for k in range(stream.num_blocks)]).reshape(-1, 8, 8)
        blocks = scalar.dequantize_idct_blocks(coeffs, qtab)
        planes.append(scalar.blocks_to_plane(blocks, ph, pw))

    header = yuv.YUVHeader(
        fourcc_format=img.header.fourcc_format,
        data_size=0,  # set by from_planes path below
        compression=yuv.Compressions.NONE,
        width=img.width, height=img.height,
        data_pos=yuv.HEADER_SIZE)
    out = yuv.YUVImage.from_planes(
        img.header.fourcc_format, planes, img.width, img.height)
    out.header = header
    out.header.data_size = out.data.size
    return out


def _plane_wh(img: yuv.YUVImage, i: int):
    return img.plane_shape(i)


def bmp_to_iyuv_host(bmp) -> yuv.YUVImage:
    """BMP XRGB8888 -> IYUV on the host (myyuv_yuv.cpp:88-127 semantics)."""
    if bmp.header.bit_count != 32:
        raise MyYUVError("only 32-bit XRGB8888 BMP inputs are supported")
    pixels = bmp.pixels_topdown()
    y, u, v = scalar.bgrx_to_iyuv(pixels)
    return yuv.YUVImage.from_planes(
        yuv.FourccFormats.IYUV, [y, u, v],
        bmp.true_width, bmp.true_height)


def register_host_codecs() -> None:
    """Register the host paths in the format/codec registry."""
    yuv.BMP_TO_YUV.setdefault(yuv.FourccFormats.IYUV, bmp_to_iyuv_host)
    yuv.register_codec(yuv.Compressions.DCT, yuv.FourccFormats.IYUV,
                       compress_dct_host, decompress_dct_host)
