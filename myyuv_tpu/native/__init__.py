"""Native code: the host codec library and the device codec kernels.

``load()`` returns (building on first use if necessary)
``libmyyuv_entropy.so`` — the C++ per-block Huffman encode/decode engine
(entropy.cpp) — through ctypes, or None when no compiler is available, and
callers (engine, host codec) drop back to the vectorized/py oracle paths.

``build_codec_kernels(platform)`` builds the word-frame codec kernels
(codec_kernels.cu, called through jax.ffi by kernels/codec.py); there is
no fallback for those. Both libraries compile block_codec.h.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
_LIB_PATH = _DIR / "libmyyuv_entropy.so"
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

LANE = 256  # must match kLane in entropy.cpp and dct_stream.MAX_CHUNK


def _default_threads() -> int:
    env = os.environ.get("MYYUV_NATIVE_THREADS")
    if env:
        return max(1, int(env))
    return max(1, os.cpu_count() or 1)


def _stale(out: Path, *srcs: Path) -> bool:
    return (not out.exists()
            or out.stat().st_mtime < max(s.stat().st_mtime for s in srcs))


def _compile(cmd, out: Path) -> None:
    """Run a compiler command writing ``out`` through a private temporary
    file, so concurrent builders (test workers) never load a half-written
    library."""
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(cmd + ["-o", str(tmp)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def build(force: bool = False) -> bool:
    """Compile the shared library (also when a source is newer than the
    binary — an ABI-stale .so would silently corrupt streams); returns
    True on success."""
    src = _DIR / "entropy.cpp"
    if not force and not _stale(_LIB_PATH, src, _DIR / "block_codec.h"):
        return True
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
           "-ffp-contract=off", "-pthread", f"-I{_DIR}", str(src)]
    try:
        _compile(cmd, _LIB_PATH)
    except Exception:
        return False
    return _LIB_PATH.exists()


_BUILD_DIR = _DIR.parent.parent / "build"
_CUDA_ARCH = "-gencode=arch=compute_90a,code=sm_90a"


def nvcc() -> str:
    """The CUDA compiler: on PATH, else under $CUDA_HOME (default
    /usr/local/cuda)."""
    return shutil.which("nvcc") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def build_codec_kernels(platform: str) -> Path:
    """Build (when missing or stale) the word-frame codec kernels of
    codec_kernels.cu for ``platform`` into ``<checkout>/build`` and
    return the library path.

    ``"gpu"``: nvcc for Hopper (sm_90a), -fmad=false so the transform's
    multiply-adds stay separately rounded. ``"cpu"``: the same source as
    C++ through g++ with -ffp-contract=off. Raises if the build fails —
    callers never fall back to another implementation."""
    import jax.ffi
    src = _DIR / "codec_kernels.cu"
    out = _BUILD_DIR / f"libmyyuv_codec_{platform}.so"
    if not _stale(out, src, _DIR / "block_codec.h"):
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    inc = [f"-I{jax.ffi.include_dir()}", f"-I{_DIR}"]
    if platform == "gpu":
        cmd = [nvcc(), _CUDA_ARCH, "-std=c++17", "-O3", "-fmad=false",
               "-shared", "-Xcompiler", "-fPIC", *inc, str(src)]
    elif platform == "cpu":
        cmd = ["g++", "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
               "-ffp-contract=off", *inc, str(src)]
    else:
        raise ValueError(f"no codec kernel build for platform {platform!r}")
    try:
        _compile(cmd, out)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"building {out.name} failed:\n{e.stderr}") from e
    except OSError as e:
        raise RuntimeError(f"building {out.name} failed: {e}") from e
    return out


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    if not build():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        _load_failed = True
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.myyuv_encode_blocks.restype = ctypes.c_int64
    lib.myyuv_encode_blocks.argtypes = [
        i16p, ctypes.c_int64, u8p, u8p, ctypes.c_int32]
    lib.myyuv_compact_lanes.restype = ctypes.c_int64
    lib.myyuv_compact_lanes.argtypes = [
        u8p, u8p, ctypes.c_int64, u8p, ctypes.c_int32]
    lib.myyuv_decode_blocks.restype = ctypes.c_int64
    lib.myyuv_decode_blocks.argtypes = [
        u8p, u8p, ctypes.c_int64, ctypes.c_int64, i16p, ctypes.c_int32]
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.myyuv_repack_words.restype = ctypes.c_int64
    lib.myyuv_repack_words.argtypes = [u32p, i32p, ctypes.c_int64,
                                       ctypes.c_int32, u8p]
    lib.myyuv_expand_words.restype = ctypes.c_int64
    lib.myyuv_expand_words.argtypes = [u8p, i32p, ctypes.c_int64,
                                       ctypes.c_int32, u32p]
    lib.myyuv_repack_split.restype = ctypes.c_int64
    lib.myyuv_repack_split.argtypes = [u32p, u32p, i32p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int64, u8p]
    lib.myyuv_expand_split.restype = ctypes.c_int64
    lib.myyuv_expand_split.argtypes = [u8p, i32p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int64,
                                       u32p, u32p]
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.myyuv_compress_plane.restype = ctypes.c_int64
    lib.myyuv_compress_plane.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, f32p, u8p, u8p,
        ctypes.c_int32]
    lib.myyuv_decompress_plane.restype = ctypes.c_int64
    lib.myyuv_decompress_plane.argtypes = [
        u8p, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, f32p,
        u8p, ctypes.c_int32]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i16p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def encode_blocks(coeffs: np.ndarray,
                  n_threads: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """int16 [N, 64] (or [N, 8, 8]) coefficients -> (chunk_sizes u8[N],
    content u8[total]) ragged stream, parallel over blocks."""
    lib = load()
    assert lib is not None, "native entropy library unavailable"
    coeffs = np.ascontiguousarray(coeffs.reshape(-1, 64), np.int16)
    n = coeffs.shape[0]
    lanes = np.empty((n, LANE), np.uint8)
    sizes = np.empty(n, np.uint8)
    nt = n_threads or _default_threads()
    err = lib.myyuv_encode_blocks(_i16p(coeffs), n, _u8p(lanes),
                                  _u8p(sizes), nt)
    if err != 0:
        raise ValueError(f"native encode failed at block {err - 1}")
    content = np.empty(int(sizes.astype(np.int64).sum()), np.uint8)
    lib.myyuv_compact_lanes(_u8p(lanes), _u8p(sizes), n, _u8p(content), nt)
    return sizes, content


def decode_blocks(sizes: np.ndarray, content: np.ndarray,
                  n_threads: Optional[int] = None) -> np.ndarray:
    """(chunk_sizes u8[N], content u8[total]) -> int16 [N, 64] coefficients."""
    from ..runtime.errors import BitstreamError
    lib = load()
    assert lib is not None, "native entropy library unavailable"
    sizes = np.ascontiguousarray(sizes, np.uint8)
    content = np.ascontiguousarray(content, np.uint8)
    n = sizes.size
    out = np.empty((n, 64), np.int16)
    err = lib.myyuv_decode_blocks(_u8p(sizes), _u8p(content),
                                  content.size, n, _i16p(out),
                                  n_threads or _default_threads())
    if err == 15:
        raise BitstreamError("content buffer shorter than chunk sizes imply")
    if err != 0:
        raise BitstreamError(
            f"native decode failed at block {err // 16 - 1}"
            f" (code {err % 16})")
    return out


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def compress_plane(plane: np.ndarray, qtable: np.ndarray,
                   n_threads: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Fused native CPU compress: [H, W] u8 + qtable f32[8,8] ->
    (chunk_sizes u8[N], content u8[total]). Bit-exact with the device and
    scalar paths (entropy.cpp is built with -ffp-contract=off)."""
    lib = load()
    assert lib is not None, "native library unavailable"
    plane = np.ascontiguousarray(plane, np.uint8)
    qt = np.ascontiguousarray(qtable, np.float32).reshape(64)
    h, w = plane.shape
    n = (h // 8) * (w // 8)
    lanes = np.empty((n, LANE), np.uint8)
    sizes = np.empty(n, np.uint8)
    nt = n_threads or _default_threads()
    err = lib.myyuv_compress_plane(_u8p(plane), w, h, _f32p(qt),
                                   _u8p(lanes), _u8p(sizes), nt)
    if err != 0:
        raise ValueError(f"native compress failed at block {err - 1}")
    content = np.empty(int(sizes.astype(np.int64).sum()), np.uint8)
    lib.myyuv_compact_lanes(_u8p(lanes), _u8p(sizes), n, _u8p(content), nt)
    return sizes, content


def decompress_plane(sizes: np.ndarray, content: np.ndarray,
                     qtable: np.ndarray, h: int, w: int,
                     n_threads: Optional[int] = None) -> np.ndarray:
    """Fused native CPU decompress -> [H, W] u8 plane."""
    from ..runtime.errors import BitstreamError
    lib = load()
    assert lib is not None, "native library unavailable"
    sizes = np.ascontiguousarray(sizes, np.uint8)
    content = np.ascontiguousarray(content, np.uint8)
    qt = np.ascontiguousarray(qtable, np.float32).reshape(64)
    plane = np.empty((h, w), np.uint8)
    err = lib.myyuv_decompress_plane(
        _u8p(sizes), _u8p(content), content.size, w, h, _f32p(qt),
        _u8p(plane), n_threads or _default_threads())
    if err == 15:
        raise BitstreamError("content buffer shorter than chunk sizes imply")
    if err != 0:
        raise BitstreamError(
            f"native decompress failed at block {err // 16 - 1}"
            f" (code {err % 16})")
    return plane


# ---------------------------------------------------------------------------
# Word-aligned device interchange <-> exact byte stream (with numpy
# fallbacks so the conversion works without a compiler)
# ---------------------------------------------------------------------------

_BITREV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _chunk_words(sizes: np.ndarray, align: int) -> np.ndarray:
    """Words each chunk occupies: ceil(size / (4*align)) groups of align."""
    cb = 4 * align
    return ((sizes.astype(np.int64) + cb - 1) // cb) * align


def repack_words(words: np.ndarray, sizes: np.ndarray,
                 align: int = 1) -> np.ndarray:
    """Aligned kernel-space word stream -> exact packed byte stream.

    ``words``: i32/u32 [total_words] (each chunk padded to ``align`` words,
    bytes bit-reversed big-endian in each word); ``sizes``: per-block chunk
    bytes. Returns u8 [sum(sizes)]."""
    sizes = np.ascontiguousarray(sizes, np.int32)
    words = np.ascontiguousarray(words).view(np.uint32).reshape(-1)
    total = int(sizes.astype(np.int64).sum())
    lib = load()
    if lib is not None:
        out = np.empty(total, np.uint8)
        lib.myyuv_repack_words(
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            sizes.size, align, _u8p(out))
        return out
    # numpy fallback: word stream -> per-word bytes, gather the live ones
    w4 = _chunk_words(sizes, align)
    woffs = np.cumsum(w4) - w4
    by = np.empty((words.size, 4), np.uint8)
    for j in range(4):
        by[:, j] = _BITREV8[(words >> (24 - 8 * j)) & 0xFF]
    flat = by.reshape(-1)
    # source byte index for each output byte
    boffs = np.cumsum(sizes.astype(np.int64)) - sizes
    block_of = np.repeat(np.arange(sizes.size), sizes)
    j_in = np.arange(total) - boffs[block_of]
    return flat[woffs[block_of] * 4 + j_in]


def expand_words(content: np.ndarray, sizes: np.ndarray,
                 align: int = 1) -> np.ndarray:
    """Exact packed byte stream -> aligned kernel-space word stream (i32)."""
    sizes = np.ascontiguousarray(sizes, np.int32)
    content = np.ascontiguousarray(content, np.uint8)
    w4 = _chunk_words(sizes, align)
    totalw = int(w4.sum())
    lib = load()
    if lib is not None:
        out = np.empty(totalw, np.uint32)
        lib.myyuv_expand_words(
            _u8p(content), sizes.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)),
            sizes.size, align,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return out.view(np.int32)
    woffs = np.cumsum(w4) - w4
    boffs = np.cumsum(sizes.astype(np.int64)) - sizes
    block_of = np.repeat(np.arange(sizes.size), sizes)
    j_in = np.arange(content.size) - boffs[block_of]
    flat = np.zeros(totalw * 4, np.uint8)
    flat[woffs[block_of] * 4 + j_in] = _BITREV8[content]
    by = flat.reshape(-1, 4).astype(np.uint32)
    return ((by[:, 0] << 24) | (by[:, 1] << 16) | (by[:, 2] << 8)
            | by[:, 3]).view(np.int32)


# ---------------------------------------------------------------------------
# Split-stream device interchange <-> exact byte stream
# ---------------------------------------------------------------------------


def repack_split(a: np.ndarray, b: np.ndarray, sizes: np.ndarray) \
        -> np.ndarray:
    """Split-stream interchange -> exact packed byte stream.

    ``a``: i32/u32 [64, a_cols] PACKED-8 A region (the decode kernels'
    W0 window layout: word w of block i at a[8*w + i%8, i//8];
    a_cols >= ceil(N/8), extra lane columns ignored); ``b``: i32/u32
    [capb, 8] continuation rows, globally stream-compacted back to back
    in block order; ``sizes``: per-block chunk bytes.
    Returns u8 [sum(sizes)]."""
    sizes = np.ascontiguousarray(sizes, np.int32)
    n = sizes.size
    a_u = np.ascontiguousarray(a).view(np.uint32)
    a_cols = a_u.size // 64
    a_u = a_u.reshape(64, a_cols)
    b_u = np.ascontiguousarray(b).view(np.uint32).reshape(-1, 8)
    total = int(sizes.astype(np.int64).sum())
    lib = load()
    if lib is not None:
        out = np.empty(total, np.uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.myyuv_repack_split(
            a_u.ctypes.data_as(u32p), b_u.ctypes.data_as(u32p),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, a_cols, b_u.shape[0], _u8p(out))
        return out
    # numpy fallback: rebuild the plain 4-byte-aligned word stream and
    # reuse repack_words
    w1 = (sizes.astype(np.int64) + 3) // 4
    woffs = np.cumsum(w1) - w1
    nbr = np.maximum((sizes.astype(np.int64) + 31) // 32 - 1, 0)
    boffs = np.cumsum(nbr) - nbr
    flat = np.zeros(int(w1.sum()), np.uint32)
    block_of = np.repeat(np.arange(n), w1)
    k_in = np.arange(flat.size) - woffs[block_of]
    low = k_in < 8
    bl = block_of[low]
    flat[low] = a_u[8 * k_in[low] + bl % 8, bl // 8]
    hi = ~low
    if hi.any():
        flat[hi] = b_u[boffs[block_of[hi]] + (k_in[hi] - 8) // 8,
                       (k_in[hi] - 8) % 8]
    return repack_words(flat.view(np.int32), sizes, align=1)


def expand_split(content: np.ndarray, sizes: np.ndarray,
                 capb: int | None = None):
    """Exact packed byte stream -> split-stream interchange
    (a i32 [64, ceil8(N)] packed-8 W0 layout, b i32 [capb, 8] globally
    stream-compacted continuation rows; ``capb`` defaults to the exact
    live row count)."""
    sizes = np.ascontiguousarray(sizes, np.int32)
    content = np.ascontiguousarray(content, np.uint8)
    n = sizes.size
    a_cols = (n + 7) // 8
    nbr = np.maximum(
        (sizes.astype(np.int64) + 31) // 32 - 1, 0)
    if capb is None:
        capb = max(int(nbr.sum()), 1)
    lib = load()
    if lib is not None:
        a = np.empty((64, a_cols), np.uint32)
        b = np.empty((capb, 8), np.uint32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.myyuv_expand_split(
            _u8p(content),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, a_cols, capb, a.ctypes.data_as(u32p),
            b.ctypes.data_as(u32p))
        return a.view(np.int32), b.view(np.int32)
    words = expand_words(content, sizes, align=1).view(np.uint32)
    w1 = (sizes.astype(np.int64) + 3) // 4
    woffs = np.cumsum(w1) - w1
    boffs = np.cumsum(nbr) - nbr
    block_of = np.repeat(np.arange(n), w1)
    k_in = np.arange(words.size) - woffs[block_of]
    a = np.zeros((64, a_cols), np.uint32)
    pad_blocks = np.arange(n, 8 * a_cols)
    a[pad_blocks % 8, pad_blocks // 8] = 0x8000C000  # _FILLER_W0
    low = k_in < 8
    bl = block_of[low]
    a[8 * k_in[low] + bl % 8, bl // 8] = words[low]
    b = np.zeros((capb, 8), np.uint32)
    hi = ~low
    if hi.any():
        b[boffs[block_of[hi]] + (k_in[hi] - 8) // 8,
          (k_in[hi] - 8) % 8] = words[hi]
    return a.view(np.int32), b.view(np.int32)
