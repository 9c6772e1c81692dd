"""Command-line driver mirroring the reference ``myyuv_cli``.

Command surface (reference: myyuv_cli/main.cpp:80-98 usage, 215-244 magic
dispatch) plus device-era extensions:

  myyuv <image> -info
  myyuv <image.bmp> -to_yuv IYUV [-o out.myyuv]
  myyuv <image.myyuv> -compress DCT q [q2 q3] [-o out.myyuv]
  myyuv <image.myyuv> -decompress [-o out.myyuv]
  myyuv <image> -rgb [-o out.bmp]       # viewer-equivalent RGB export
  myyuv <image> -preview [-o out.txt]   # terminal preview (viewer stand-in)

Input type is sniffed from the two magic bytes ("BM" vs "YU") exactly like
the reference (main.cpp:215-234). Each operation prints a wall-clock timing
line "<op> : N ms" like the reference MyTimer (main.cpp:11-41).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from .formats.bmp import BMPImage
from .formats.yuv import Compressions, FourccFormats, YUVImage
from .runtime.errors import MyYUVError

_FORMATS = {"IYUV": FourccFormats.IYUV}
_COMPRESSIONS = {"DCT": Compressions.DCT}
_PLATFORMS = ("auto", "cpu", "gpu")


class _Timer:
    """Wall-clock op timing, printed like the reference MyTimer
    (myyuv_cli/main.cpp:11-41)."""

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            ms = (time.perf_counter() - self.t0) * 1e3
            print(f"{self.label} : {ms:.3f} ms")


def _sniff(path: Path) -> str:
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"BM":
        return "bmp"
    if magic == b"YU":
        return "yuv"
    raise MyYUVError(f"Unknown image magic {magic!r} in {path}")


def _fill_qualities(vals: List[int]) -> bytes:
    """1-3 quality values; the last given fills the rest
    (myyuv_cli/main.cpp:56-78)."""
    if not 1 <= len(vals) <= 3:
        raise MyYUVError("compress takes 1 to 3 quality parameters")
    for v in vals:
        if not 1 <= v <= 100:
            raise MyYUVError("Level of quality must be between 1 and 100")
    out = list(vals) + [vals[-1]] * (3 - len(vals))
    return bytes(out)


def _print_bmp_info(bmp: BMPImage) -> None:
    h = bmp.header
    print("BMP image")
    print(f"  size: {h.file_size}")
    print(f"  width: {bmp.true_width}")
    print(f"  height: {bmp.true_height}  (stored {h.height},"
          f" {'bottom-up' if h.height > 0 else 'top-down'})")
    print(f"  bit_count: {h.bit_count}")
    print(f"  data_pos: {h.data_pos}")


def _print_yuv_info(img: YUVImage) -> None:
    h = img.header
    name = img.descriptor.name if h.fourcc_format in _FORMATS.values() \
        else hex(h.fourcc_format)
    comp = {0: "NONE", 1: "DCT"}.get(h.compression, str(h.compression))
    print(".myyuv image")
    print(f"  format: {name}")
    print(f"  width: {h.width}")
    print(f"  height: {h.height}")
    print(f"  compression: {comp}")
    print(f"  data_size: {h.data_size}")
    if h.compression_params_size:
        params = list(img.compression_params)
        print(f"  compression_params: {params}")


def _default_out(path: Path, suffix: str, tag: str) -> Path:
    return path.with_name(path.stem + tag + suffix)


def _export_rgb(img_path: Path, kind: str, out: Optional[Path]) -> None:
    from .viewer import export
    with _Timer("rgb export"):
        if kind == "bmp":
            bgrx = export.ensure_bgrx(BMPImage.load(img_path).pixels_topdown())
        else:
            from .engine import pipeline
            bgrx = pipeline.iyuv_to_bgrx(YUVImage.load(img_path))
    out = out or _default_out(img_path, ".bmp", "-rgb")
    export.write_bgrx_bmp(out, bgrx)
    print(f"wrote {out}")


def _preview(img_path: Path, kind: str, out: Optional[Path]) -> None:
    from .viewer import export, terminal
    if kind == "bmp":
        bgrx = export.ensure_bgrx(BMPImage.load(img_path).pixels_topdown())
    else:
        from .engine import pipeline
        bgrx = pipeline.iyuv_to_bgrx(YUVImage.load(img_path))
    text = terminal.render_ansi(bgrx)
    if out:
        Path(out).write_text(text)
        print(f"wrote {out}")
    else:
        print(text)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="myyuv",
        description="myyuv codec CLI on JAX (reference: myyuv_cli)")
    p.add_argument("image", type=Path)
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("-info", action="store_true")
    g.add_argument("-to_yuv", metavar="FORMAT")
    g.add_argument("-compress", nargs="+", metavar=("TYPE", "QUALITY"))
    g.add_argument("-decompress", action="store_true")
    g.add_argument("-rgb", action="store_true",
                   help="decode to an RGB .bmp (viewer-equivalent export)")
    g.add_argument("-preview", action="store_true",
                   help="render to ANSI truecolor in the terminal")
    g.add_argument("-cube", action="store_true",
                   help="render the spinning-textured-cube demo frames "
                        "(software analog of myyuv_opengl_spinning_cube)")
    p.add_argument("-frames", type=int, default=24,
                   help="frame count for -cube")
    p.add_argument("-size", type=int, default=512,
                   help="output resolution for -cube (0 = the reference "
                        "1000x800 screen)")
    p.add_argument("-shapes", type=int, default=1, metavar="N",
                   help="number of shapes, 1..1000, placed without overlap"
                        " (spinning_cube.cpp:288-312)")
    p.add_argument("-force_cube", action="store_true",
                   help="force a cube even for non-square images "
                        "(spinning_cube main.cpp:20-57)")
    p.add_argument("-flip_width_height", action="store_true",
                   help="swap texture width/height for the shape aspect "
                        "(no-op with -force_cube)")
    p.add_argument("-fly", action="store_true",
                   help="drive the fly camera along the scripted path "
                        "(headless stand-in for WASD/arrows)")
    p.add_argument("-o", "--output", type=Path, default=None)
    p.add_argument("--platform", choices=_PLATFORMS,
                   default="auto",
                   help="JAX platform for the compute path (default auto; "
                        "'cpu' avoids device compiles for one-shot use)")
    p.add_argument("--backend", choices=["auto", "device", "native", "cpu"],
                   default="auto",
                   help="codec backend: 'device' = fully on-chip entropy, "
                        "'native' = device transform + C++ host entropy, "
                        "'cpu' = fused native CPU codec")
    args = p.parse_args(argv)

    if args.platform != "auto":
        import jax
        jax.config.update("jax_platforms", args.platform)
    from .runtime import jaxcache
    jaxcache.enable()

    try:
        kind = _sniff(args.image)

        if args.info:
            if kind == "bmp":
                _print_bmp_info(BMPImage.load(args.image))
            else:
                _print_yuv_info(YUVImage.load(args.image))
            return 0

        if args.rgb:
            _export_rgb(args.image, kind, args.output)
            return 0

        if args.preview:
            _preview(args.image, kind, args.output)
            return 0

        if args.cube:
            from .viewer import cube
            from .viewer import export as vexport
            if kind == "bmp":
                tex = vexport.ensure_bgrx(
                    BMPImage.load(args.image).pixels_topdown())
            else:
                from .engine import pipeline
                tex = pipeline.iyuv_to_bgrx(YUVImage.load(args.image))
            out = args.output or _default_out(args.image, "", "-cube")
            with _Timer("cube render"):
                paths = cube.render_spinning_cube(
                    tex, out, n_frames=args.frames, out_size=args.size,
                    shapes=args.shapes, force_cube=args.force_cube,
                    flip_width_height=args.flip_width_height,
                    fly_script=(cube.default_fly_script if args.fly
                                else None))
            print(f"wrote {len(paths)} frames to {out}/")
            return 0

        if args.to_yuv is not None:
            if kind != "bmp":
                raise MyYUVError("-to_yuv needs a BMP input")
            fmt = _FORMATS.get(args.to_yuv.upper())
            if fmt is None:
                raise MyYUVError(f"Unknown YUV format {args.to_yuv}")
            bmp = BMPImage.load(args.image)
            with _Timer("to yuv"):
                img = YUVImage.from_bmp(bmp, fmt)
            out = args.output or _default_out(args.image, ".myyuv", "")
            img.dump(out)
            print(f"wrote {out}")
            return 0

        if kind != "yuv":
            raise MyYUVError("this command needs a .myyuv input")
        img = YUVImage.load(args.image)

        if args.compress is not None:
            ctype = _COMPRESSIONS.get(args.compress[0].upper())
            if ctype is None:
                raise MyYUVError(f"Unknown compression {args.compress[0]}")
            params = _fill_qualities([int(v) for v in args.compress[1:]])
            with _Timer("compression"):
                if args.backend != "auto":
                    from .engine import pipeline
                    comp = pipeline.compress_dct(
                        img, params, entropy_backend=args.backend)
                else:
                    comp = img.compress(ctype, params)
            out = args.output or _default_out(
                args.image, ".myyuv", f"-DCT-{params[0]}")
            comp.dump(out)
            ratio = img.header.data_size / comp.header.data_size
            print(f"wrote {out}  ({comp.header.data_size} bytes,"
                  f" {ratio:.2f}x)")
            return 0

        if args.decompress:
            with _Timer("decompression"):
                if args.backend != "auto" and img.is_compressed():
                    from .engine import pipeline
                    dec = pipeline.decompress_dct(
                        img, entropy_backend=args.backend)
                else:
                    dec = img.decompress()
            out = args.output or _default_out(args.image, ".myyuv", "-decomp")
            dec.dump(out)
            print(f"wrote {out}")
            return 0
    except MyYUVError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
