"""``.myyuv`` container + fourcc/codec registry.

Re-design of the reference YUV container and its
extensible-by-registry dispatch (``myyuv_lib/myyuv_yuv.{hpp,cpp}``). The
container is a host-side dataclass over NumPy byte arrays; the registry maps
fourcc formats to geometry descriptors and converter/codec callables, exactly
like the seven static maps of the reference (myyuv_yuv.hpp:88-121) but as one
``FormatDescriptor`` plus codec tables.

File format contract (SURVEY.md §7.1, myyuv_yuv.hpp:13-29):
  64-byte packed header: "YU" magic, u32 fourcc, u32 data_size (payload bytes),
  u16 compression, u32 params_size, u32 params_pos, u32 width, u32 height,
  u32 data_pos, 32 unused bytes. On write params sit at offset 64 and data at
  64 + params_size; the loader re-normalizes positions (myyuv_yuv.cpp:500-502).
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np

from ..runtime.errors import FormatError, UnsupportedError
from .bmp import BMPImage

_YUV_HDR = struct.Struct("<2s I I H I I I I I 32s")
assert _YUV_HDR.size == 64
HEADER_SIZE = 64


def fourcc(code: str) -> int:
    """fourcc string -> little-endian u32 (e.g. 'IYUV' -> 0x56555949)."""
    assert len(code) == 4
    return int.from_bytes(code.encode("ascii"), "little")


class FourccFormats:
    """Known fourcc formats (myyuv_yuv.hpp:56-59)."""

    UNKNOWN = 0
    IYUV = fourcc("IYUV")


class Compressions:
    """Known compressions (myyuv_yuv.hpp:69-72)."""

    NONE = 0
    DCT = 1


class FormatGroup:
    """Plane layout classes (myyuv_yuv.hpp:46)."""

    UNKNOWN = 0
    PACKED = 1
    PLANAR = 2
    SEMI_PLANAR = 3


MAX_PLANES = 4       # myyuv_yuv.hpp:77
NO_PLANE = 0xFF      # myyuv_yuv.hpp:82


@dataclasses.dataclass(frozen=True)
class FormatDescriptor:
    """Geometry descriptor for one fourcc format.

    Folds the reference's yuv_format_group_map / yuv_order_planes_map /
    yuv_resolution_fraction_map (myyuv_yuv.cpp:74-86) into one record.
    """

    fourcc: int
    name: str
    group: int
    plane_order: Tuple[int, ...]          # index -> plane id, NO_PLANE if absent
    resolution_fraction: Tuple[int, int]  # chroma (w_div, h_div); IYUV -> (2, 2)

    def format_size_bits(self) -> Tuple[int, ...]:
        """Per-plane bits contribution (myyuv_yuv.cpp:327-343)."""
        frac = self.resolution_fraction[0] * self.resolution_fraction[1]
        assert 8 % frac == 0
        bits = [8, 8 // frac, 8 // frac, 8]
        for i, o in enumerate(self.plane_order):
            if o == NO_PLANE:
                bits[i] = 0
        return tuple(bits)


# ---------------------------------------------------------------------------
# Registry (the pythonic analog of the 7 static maps, myyuv_yuv.hpp:88-121)
# ---------------------------------------------------------------------------

FORMATS: Dict[int, FormatDescriptor] = {}
# fourcc -> converter(BMPImage) -> YUVImage
BMP_TO_YUV: Dict[int, Callable[[BMPImage], "YUVImage"]] = {}
# (compression, fourcc) -> compress(YUVImage, params: bytes) -> YUVImage
COMPRESSORS: Dict[Tuple[int, int], Callable[["YUVImage", bytes], "YUVImage"]] = {}
# (compression, fourcc) -> decompress(YUVImage) -> YUVImage
DECOMPRESSORS: Dict[Tuple[int, int], Callable[["YUVImage"], "YUVImage"]] = {}
# fourcc -> get_pixel(YUVImage, x, y) -> tuple per plane
GET_PIXEL: Dict[int, Callable[["YUVImage", int, int], Tuple[int, ...]]] = {}


def register_format(desc: FormatDescriptor,
                    bmp_to_yuv: Optional[Callable] = None,
                    get_pixel: Optional[Callable] = None) -> None:
    FORMATS[desc.fourcc] = desc
    if bmp_to_yuv is not None:
        BMP_TO_YUV[desc.fourcc] = bmp_to_yuv
    if get_pixel is not None:
        GET_PIXEL[desc.fourcc] = get_pixel


def register_codec(compression: int, fcc: int,
                   compressor: Callable, decompressor: Callable) -> None:
    COMPRESSORS[(compression, fcc)] = compressor
    DECOMPRESSORS[(compression, fcc)] = decompressor


def is_implemented(fcc: int, compression: int = Compressions.NONE) -> bool:
    """Mirrors YUV::isImplementedFormat (myyuv_yuv.cpp:264-276)."""
    if fcc not in FORMATS or fcc not in BMP_TO_YUV:
        return False
    if compression != Compressions.NONE:
        return (compression, fcc) in COMPRESSORS and (compression, fcc) in DECOMPRESSORS
    return True


# ---------------------------------------------------------------------------
# Container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class YUVHeader:
    """Packed 64-byte .myyuv header (myyuv_yuv.hpp:17-28)."""

    fourcc_format: int = 0
    data_size: int = 0
    compression: int = 0
    compression_params_size: int = 0
    compression_params_pos: int = 0
    width: int = 0
    height: int = 0
    data_pos: int = 0
    unused: bytes = b"\x00" * 32

    def pack(self) -> bytes:
        return _YUV_HDR.pack(b"YU", self.fourcc_format, self.data_size,
                             self.compression, self.compression_params_size,
                             self.compression_params_pos, self.width,
                             self.height, self.data_pos, self.unused)

    @classmethod
    def unpack(cls, raw: bytes) -> "YUVHeader":
        (magic, fcc, data_size, compression, params_size, params_pos,
         width, height, data_pos, unused) = _YUV_HDR.unpack(raw[:64])
        if magic != b"YU":
            raise FormatError("not a .myyuv file (bad magic)")
        return cls(fcc, data_size, compression, params_size, params_pos,
                   width, height, data_pos, unused)


@dataclasses.dataclass
class YUVImage:
    """A .myyuv image: header + compression params + payload bytes."""

    header: YUVHeader
    compression_params: Optional[np.ndarray] = None  # uint8 or None
    data: Optional[np.ndarray] = None                # uint8 payload

    # -- basic accessors ----------------------------------------------------
    @property
    def width(self) -> int:
        return self.header.width

    @property
    def height(self) -> int:
        return self.header.height

    @property
    def compression(self) -> int:
        return self.header.compression

    def is_compressed(self) -> bool:
        return self.header.compression != Compressions.NONE

    @property
    def descriptor(self) -> FormatDescriptor:
        try:
            return FORMATS[self.header.fourcc_format]
        except KeyError:
            raise UnsupportedError(
                f"format 0x{self.header.fourcc_format:08x} not registered")

    # -- validity (myyuv_yuv.cpp:248-262) ------------------------------------
    def is_valid_header(self) -> bool:
        h = self.header
        return (is_implemented(h.fourcc_format, h.compression)
                and h.width > 0 and h.height > 0
                and h.data_pos >= HEADER_SIZE + h.compression_params_size
                and h.data_size > 0)

    def is_valid(self) -> bool:
        if self.data is None:
            return False
        h = self.header
        params_ok = (
            (h.compression_params_size > 0 and self.compression_params is not None)
            or (h.compression == Compressions.NONE and self.compression_params is None)
            or (h.compression_params_size == 0 and self.compression_params is None)
        )
        return params_ok and self.is_valid_header()

    # -- geometry (myyuv_yuv.cpp:309-381) ------------------------------------
    def plane_shape(self, channel: int) -> Tuple[int, int]:
        """(width, height) of plane `channel` (myyuv_yuv.cpp:309-325)."""
        desc = self.descriptor
        if desc.plane_order[channel] == NO_PLANE:
            return (0, 0)
        if channel in (1, 2):
            fw, fh = desc.resolution_fraction
            return (self.width // fw, self.height // fh)
        return (self.width, self.height)

    def image_size(self) -> int:
        """Uncompressed payload size (myyuv_yuv.cpp:374-381)."""
        bits = self.descriptor.format_size_bits()
        return sum(self.width * self.height * b // 8 for b in bits)

    def plane_offsets(self):
        """Per-plane byte offsets into the payload (None = absent).

        The array analog of getYUVPlanes' pointer walk
        (myyuv_yuv.cpp:383-427): sequential prefix offsets in plane_order
        sequence; PACKED planes all alias offset 0; zero-size channels
        drop to None; SEMI_PLANAR chroma channels share one offset
        (res[2] = res[1] in the reference).
        """
        desc = self.descriptor
        bits = desc.format_size_bits()
        order = desc.plane_order
        offs = [None] * MAX_PLANES
        offs[order[0]] = 0
        prev = order[0]
        for o in order[1:]:
            if o == NO_PLANE:
                continue
            offs[o] = (0 if desc.group == FormatGroup.PACKED
                       else offs[prev]
                       + self.width * self.height * bits[prev] // 8)
            prev = o
        for o in order:
            if o != NO_PLANE and bits[o] == 0:
                offs[o] = None
        if desc.group == FormatGroup.SEMI_PLANAR:
            if offs[1] is not None:
                offs[2] = offs[1]
            elif offs[2] is not None:
                offs[1] = offs[2]
        return tuple(offs)

    def planes(self):
        """List of per-plane uint8 arrays (uncompressed images only).

        Generic over the three format groups, mirroring getYUVPlanes
        (myyuv_yuv.cpp:383-427):

        * PLANAR: each plane is its own [ph, pw] view of the payload.
        * SEMI_PLANAR: luma is a [ph, pw] view; both chroma entries
          ALIAS one interleaved region, returned as the combined
          [ph, combined_bytes/ph] view for each (the caller derives
          per-channel strides, as with the reference's raw pointers).
        * PACKED: every present plane aliases the whole interleaved
          payload (res[o] = data in the reference), returned flat.
        """
        if self.is_compressed():
            raise FormatError("cannot take planes of a compressed image")
        desc = self.descriptor
        bits = desc.format_size_bits()
        offs = self.plane_offsets()
        out = [None] * MAX_PLANES
        for o in range(MAX_PLANES):
            if offs[o] is None:
                continue
            if desc.group == FormatGroup.PACKED:
                out[o] = self.data
                continue
            pw, ph = self.plane_shape(o)
            size = self.width * self.height * bits[o] // 8
            if desc.group == FormatGroup.SEMI_PLANAR and o in (1, 2):
                # combined bytes of every chroma channel aliasing this
                # offset (the interleaved UV region of an NV12-style
                # format)
                size = sum(self.width * self.height * bits[c] // 8
                           for c in (1, 2) if offs[c] == offs[o])
                if ph and size % ph == 0:
                    out[o] = self.data[offs[o]: offs[o] + size].reshape(
                        ph, size // ph)
                    continue
            if size and pw and ph:
                out[o] = self.data[offs[o]: offs[o] + size].reshape(ph, pw)
        return out

    def get_pixel(self, x: int, y: int) -> Tuple[int, ...]:
        """Per-plane sample values at (x, y) (myyuv_yuv.cpp:441-452)."""
        if self.header.fourcc_format not in GET_PIXEL:
            raise UnsupportedError("get_pixel unimplemented for this format")
        if self.is_compressed():
            raise FormatError(
                "Cannot get pixel from compressed image. Decompress first.")
        if x >= self.width or y >= self.height:
            raise FormatError("Image coordinates are out of bounds")
        return GET_PIXEL[self.header.fourcc_format](self, x, y)

    # -- codec dispatch (myyuv_yuv.cpp:454-483) -------------------------------
    def compress(self, compression: int, params: bytes) -> "YUVImage":
        if self.is_compressed():
            raise FormatError("Error already compressed")
        key = (compression, self.header.fourcc_format)
        if key not in COMPRESSORS:
            raise UnsupportedError("compression unimplemented for this format")
        return COMPRESSORS[key](self, params)

    def decompress(self) -> "YUVImage":
        if not self.is_compressed():
            return self
        key = (self.header.compression, self.header.fourcc_format)
        if key not in DECOMPRESSORS:
            raise UnsupportedError("decompression unimplemented for this format")
        return DECOMPRESSORS[key](self)

    # -- I/O (myyuv_yuv.cpp:485-536) ------------------------------------------
    @classmethod
    def load(cls, path: Union[str, Path]) -> "YUVImage":
        raw = Path(path).read_bytes()
        return cls.from_bytes(raw, name=str(path))

    @classmethod
    def from_bytes(cls, raw: bytes, name: str = "<bytes>") -> "YUVImage":
        header = YUVHeader.unpack(raw)
        img = cls(header)
        if not img.is_valid_header():
            raise FormatError(f"bad .myyuv header: {name}")
        params = None
        if header.compression_params_size > 0:
            p0 = header.compression_params_pos
            params = np.frombuffer(
                raw[p0: p0 + header.compression_params_size], np.uint8).copy()
        d0 = header.data_pos
        # re-normalize positions like the reference loader (myyuv_yuv.cpp:500-502)
        header.compression_params_pos = HEADER_SIZE
        header.data_pos = HEADER_SIZE + header.compression_params_size
        img.compression_params = params
        if header.compression == Compressions.NONE:
            header.data_size = img.image_size()
        img.data = np.frombuffer(raw[d0: d0 + header.data_size], np.uint8).copy()
        if img.data.size != header.data_size:
            raise FormatError(f"truncated .myyuv payload: {name}")
        return img

    def to_bytes(self) -> bytes:
        out = [self.header.pack()]
        if self.compression_params is not None:
            out.append(self.compression_params.tobytes())
        out.append(self.data.tobytes())
        return b"".join(out)

    def dump(self, path: Union[str, Path]) -> None:
        Path(path).write_bytes(self.to_bytes())

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_planes(cls, fcc: int, planes, width: int, height: int) -> "YUVImage":
        """Build an uncompressed image from per-plane uint8 arrays."""
        desc = FORMATS[fcc]
        chunks = []
        for o in desc.plane_order:
            if o == NO_PLANE:
                continue
            chunks.append(np.ascontiguousarray(planes[o], np.uint8).reshape(-1))
        data = np.concatenate(chunks)
        header = YUVHeader(fourcc_format=fcc, data_size=data.size,
                           width=width, height=height, data_pos=HEADER_SIZE)
        return cls(header, None, data)

    @classmethod
    def from_bmp(cls, bmp: BMPImage, fcc: int) -> "YUVImage":
        """Convert a BMP image (myyuv_yuv.cpp:512-523 dispatch)."""
        if not bmp.is_valid():
            raise FormatError("BMP is invalid")
        if fcc not in BMP_TO_YUV:
            raise UnsupportedError("Incorrect format")
        return BMP_TO_YUV[fcc](bmp)


def _iyuv_get_pixel(img: YUVImage, x: int, y: int) -> Tuple[int, int, int]:
    """IYUV sampler (myyuv_yuv.cpp:162-180)."""
    w, h = img.width, img.height
    data = img.data
    uv_index = x // 2 + y * w // 4
    return (int(data[x + y * w]),
            int(data[w * h + uv_index]),
            int(data[w * h * 5 // 4 + uv_index]))


IYUV = FormatDescriptor(
    fourcc=FourccFormats.IYUV, name="IYUV", group=FormatGroup.PLANAR,
    plane_order=(0, 1, 2, NO_PLANE), resolution_fraction=(2, 2))

register_format(IYUV, get_pixel=_iyuv_get_pixel)
