"""Smoke run of the codec on NVIDIA GPUs: the main path, bit for bit.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded phase only

Everything runs in this one process (a second JAX process could not
reserve the card's memory). Content is seeded (runtime/synthetic); every
phase compares bit for bit against the host oracles — kernels/scalar,
the native C++ codec, the plain-JAX ("xla") implementation of the codec
kernels — and raises on the first mismatch.

Phases (one card):
  device     every JAX device is a GPU; card name and power limit
  transform  kernels/device forward + inverse DCT vs kernels/scalar on
             all three 3840x2160 planes at q 10/50/90/100
  kernels    the codec kernels ("ffi") vs their XLA implementation and
             the native codec: interchange + pixels at 4K q50/q90, a
             noise frame at q95 in the roomy tier, a corrupted chunk
  main path  the CLI (to_yuv, compress with each backend, decompress),
             eight 4K frames through roundtrip_words / ingest_frame /
             preview_frame, a B=8 1920x1088 batch, the 416x240 plain
             route, and the cont-ladder climb of a q95 noise frame
The last stdout line is the JSON result; any failure exits non-zero
before printing it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

H4K, W4K = 2160, 3840


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(f"MISMATCH: {what}")


def equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    check(a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}")
    if not np.array_equal(a, b):
        bad = np.argwhere(a != b)
        raise AssertionError(f"MISMATCH: {what}: {len(bad)} elements "
                             f"differ, first at {bad[0].tolist()}")


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"[{self.name}] ...")

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"[{self.name}] ok ({time.perf_counter() - self.t0:.1f} s)")


def qtables(q):
    from myyuv_tpu.kernels import constants
    return [constants.quality_scaled_qtable(constants.PLANE_Q50[i], q)
            for i in range(3)]


def native_streams(planes, q):
    from myyuv_tpu import native
    return [native.compress_plane(p, qt) for p, qt in zip(planes, qtables(q))]


def native_decode(streams, q, h, w):
    from myyuv_tpu import native
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    return [native.decompress_plane(s, c, qt, *shp)
            for (s, c), qt, shp in zip(streams, qtables(q), shapes)]


def interchange_from_streams(streams, cont):
    """Native byte streams -> the dense (A, C) interchange."""
    from myyuv_tpu import native
    from myyuv_tpu.engine import device_stream as ds
    sizes = np.concatenate([s.astype(np.int32) for s, _ in streams])
    content = np.concatenate([c for _, c in streams])
    a, b = native.expand_split(content, sizes)
    return a, ds._dense_c_np(b, sizes, cont), sizes


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(count):
    import jax
    devs = jax.devices()
    for d in devs:
        check(d.platform == "gpu", f"device {d} is not a GPU")
    check(len(devs) >= count, f"need {count} GPUs, JAX has {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
        f"; devices {[d.device_kind for d in devs]}")
    return devs


def phase_transform(planes):
    import jax
    import jax.numpy as jnp
    from myyuv_tpu.kernels import device as kdev
    from myyuv_tpu.kernels import scalar
    fwd = jax.jit(kdev.dct_quantize)
    inv = jax.jit(kdev.dequantize_idct)
    for q in (10, 50, 90, 100):
        for i, p in enumerate(planes):
            qt = qtables(q)[i]
            blocks = scalar.plane_to_blocks(p)
            co = fwd(jnp.asarray(blocks), jnp.asarray(qt))
            want = scalar.dct_quantize_blocks(blocks, qt)
            equal(co, want, f"forward DCT q{q} plane {i}")
            equal(inv(co, jnp.asarray(qt)),
                  scalar.dequantize_idct_blocks(want, qt),
                  f"inverse DCT q{q} plane {i}")


def _kernel_case(planes, q, cont, tag):
    """Both codec implementations on one frame vs each other and native."""
    import jax
    from myyuv_tpu.engine import batch as eb
    from myyuv_tpu.engine import word_frame as wf
    from myyuv_tpu.kernels import codec
    h, w = planes[0].shape
    check(codec.default_impl() == "ffi", "GPU default codec is not ffi")
    qts = eb.plane_qtables([q] * 3)
    xw = wf.pack_frame(*[jax.numpy.asarray(p) for p in planes])
    ny8, nc8, _ = wf.frame_cols(h, w)
    n8 = ny8 + 2 * nc8
    res = {}
    for impl in codec.IMPLS:
        A, C, sizes, total, ok = wf.compress_words(
            xw, *qts, h=h, w=w, cont=cont, impl=impl)
        check(bool(ok), f"{tag} {impl}: compress ok")
        rxw, dok = wf.decompress_words(A, C, sizes, *qts, h=h, w=w,
                                       impl=impl)
        check(bool(dok), f"{tag} {impl}: decompress ok")
        res[impl] = [np.asarray(x) for x in (A, C, sizes, rxw)]
    for name, a, b in zip(("A", "C", "sizes", "pixels"), res["ffi"],
                          res["xla"]):
        equal(a, b, f"{tag}: {name} ffi vs xla")
    streams = native_streams(planes, q)
    a_n, c_n, sizes_n = interchange_from_streams(streams, cont)
    A, C, sizes, rxw = res["ffi"]
    equal(sizes, sizes_n, f"{tag}: sizes vs native")
    equal(A[:, :n8], a_n[:, :n8], f"{tag}: region A vs native")
    equal(C[:, :n8], c_n[:, :n8], f"{tag}: region C vs native")
    want = native_decode(streams, q, h, w)
    got = wf.unpack_frame(jax.numpy.asarray(rxw), h, w)
    for i in range(3):
        equal(got[i], want[i], f"{tag}: decoded plane {i} vs native")
    return A, C, sizes


def phase_kernels(natural, noise):
    import jax.numpy as jnp
    from myyuv_tpu.engine import batch as eb
    from myyuv_tpu.engine import device_stream as ds
    from myyuv_tpu.engine import word_frame as wf
    h, w = natural[0].shape
    A, C, sizes = _kernel_case(natural, 50, ds.CONT_DEFAULT, "4K q50")
    _kernel_case(natural, 90, ds.CONT_Q90, "4K q90")
    _kernel_case(noise, 95, ds.CONT_ROOMY, "4K noise q95")
    # corrupted chunk: stomp the header word of block 8*3 + 3
    bad = np.asarray(A).copy()
    bad[3, 3] ^= 0x00FFFF00
    qts = eb.plane_qtables([50] * 3)
    from myyuv_tpu.kernels import codec, words
    ny8, nc8, _ = wf.frame_cols(h, w)
    pids = words.plane_pids(8 * ny8, 8 * nc8, bad.shape[1] - ny8 - 2 * nc8)
    for impl in codec.IMPLS:
        _, okb = codec.decode(jnp.asarray(bad), jnp.asarray(C),
                              words.stack_qtables(*qts), pids, impl=impl)
        okb = np.asarray(okb)
        check(not okb[27], f"corrupt chunk not flagged ({impl})")
        check(np.delete(okb, 27).all(), f"clean chunks flagged ({impl})")
        _, dok = wf.decompress_words(jnp.asarray(bad), C, sizes, *qts,
                                     h=h, w=w, impl=impl)
        check(not bool(dok), f"frame ok despite corrupt chunk ({impl})")


def phase_cli(bgrx, tmp):
    from myyuv_tpu import YUVImage, cli
    from myyuv_tpu.engine import pipeline
    from myyuv_tpu.kernels import scalar
    from myyuv_tpu.viewer import export
    bmp = tmp / "frame.bmp"
    export.write_bgrx_bmp(bmp, bgrx)
    raw = tmp / "frame.myyuv"
    check(cli.main([str(bmp), "-to_yuv", "IYUV", "-o", str(raw)]) == 0,
          "cli -to_yuv")
    planes = YUVImage.load(raw).planes()[:3]
    for got, want, i in zip(planes, scalar.bgrx_to_iyuv(bgrx), range(3)):
        equal(got, want, f"cli -to_yuv plane {i} vs scalar")
    out = {}
    before = dict(pipeline.host_fallbacks)
    for backend in ("cpu", "auto", "device"):
        comp = tmp / f"c-{backend}.myyuv"
        dec = tmp / f"d-{backend}.myyuv"
        check(cli.main([str(raw), "-compress", "DCT", "50", "-o", str(comp),
                        "--backend", backend]) == 0, f"cli compress {backend}")
        check(cli.main([str(comp), "-decompress", "-o", str(dec),
                        "--backend", backend]) == 0,
              f"cli decompress {backend}")
        out[backend] = (comp.read_bytes(), dec.read_bytes())
    for backend in ("auto", "device"):
        check(out[backend][0] == out["cpu"][0],
              f"cli compressed file ({backend}) != cpu backend")
        check(out[backend][1] == out["cpu"][1],
              f"cli decompressed file ({backend}) != cpu backend")
    check(dict(pipeline.host_fallbacks) == before,
          f"device backend fell back to the host: {pipeline.host_fallbacks}")


def phase_words(frames):
    """Eight 4K frames through the word contract's three entries."""
    import jax.numpy as jnp
    from myyuv_tpu.engine import batch as eb
    from myyuv_tpu.engine import word_frame as wf
    from myyuv_tpu.kernels import scalar
    qts = eb.plane_qtables([50] * 3)
    h, w = H4K, W4K
    for k, bgrx in enumerate(frames):
        planes = scalar.bgrx_to_iyuv(bgrx)
        streams = native_streams(planes, 50)
        want = native_decode(streams, 50, h, w)
        xw = wf.pack_frame(*[jnp.asarray(p) for p in planes])
        rxw, total, ok = wf.roundtrip_words(xw, *qts, h=h, w=w)
        check(bool(ok), f"frame {k}: roundtrip_words ok")
        check(int(total) == sum(int(s.astype(np.int64).sum())
                                for s, _ in streams),
              f"frame {k}: roundtrip_words total bytes")
        for i, p in enumerate(wf.unpack_frame(rxw, h, w)):
            equal(p, want[i], f"frame {k}: roundtrip_words plane {i}")
        A, C, sizes, total, ok = wf.ingest_frame(jnp.asarray(bgrx), *qts,
                                                 h=h, w=w)
        check(bool(ok), f"frame {k}: ingest_frame ok")
        a_n, c_n, sizes_n = interchange_from_streams(streams, C.shape[0] // 8)
        n8 = a_n.shape[1]
        equal(sizes, sizes_n, f"frame {k}: ingest sizes vs native")
        equal(np.asarray(A)[:, :n8], a_n, f"frame {k}: ingest A vs native")
        equal(np.asarray(C)[:, :n8], c_n, f"frame {k}: ingest C vs native")
        px, dok = wf.preview_frame(A, C, sizes, *qts, h=h, w=w)
        check(bool(dok), f"frame {k}: preview_frame ok")
        equal(px, scalar.iyuv_to_bgrx(*want), f"frame {k}: preview BGRX")


def phase_batch():
    import jax.numpy as jnp
    from myyuv_tpu.engine import batch as eb
    from myyuv_tpu.engine import device_stream as ds
    from myyuv_tpu.runtime import synthetic
    b, h, w = 8, 1088, 1920
    frames = [synthetic.natural_planes(h, w, seed=100 + f) for f in range(b)]
    y, u, v = [np.stack([fr[i] for fr in frames]) for i in range(3)]
    qts = eb.plane_qtables([50] * 3)
    A, C, sizes, total, ok = ds.compress_batch(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), *qts)
    check(bool(ok), "compress_batch ok")
    sizes = np.asarray(sizes)
    ny, nc = (h // 8) * (w // 8), (h // 16) * (w // 16)
    streams = [native_streams(fr, 50) for fr in frames]
    for p, npl, off in ((0, ny, 0), (1, nc, b * ny), (2, nc, b * (ny + nc))):
        for f in range(b):
            equal(sizes[off + f * npl:off + (f + 1) * npl],
                  streams[f][p][0], f"batch frame {f} plane {p} sizes")
    ry, ru, rv, dok = ds.decompress_batch(A, C, sizes, *qts, b=b, h=h, w=w)
    check(bool(dok), "decompress_batch ok")
    for f in range(b):
        want = native_decode(streams[f], 50, h, w)
        for i, got in enumerate((ry[f], ru[f], rv[f])):
            equal(got, want[i], f"batch frame {f} plane {i}")


def phase_small_and_ladder(noise):
    import jax.numpy as jnp
    from myyuv_tpu.engine import batch as eb
    from myyuv_tpu.engine import device_stream as ds
    from myyuv_tpu.runtime import synthetic
    # 416x240: chroma block counts are not whole lane columns, so the
    # frame takes the plain-JAX route (h, w still codec-legal)
    h, w = 240, 416
    check(not ds._use_packed("exact", h, w), "416x240 should be off-packed")
    planes = synthetic.natural_planes(h, w, seed=7)
    qts = eb.plane_qtables([50] * 3)
    A, C, sizes, total, ok = ds.compress_frame(
        *[jnp.asarray(p) for p in planes], *qts)
    check(bool(ok), "416x240 compress ok")
    streams = native_streams(planes, 50)
    equal(sizes, np.concatenate([s for s, _ in streams]).astype(np.int32),
          "416x240 sizes vs native")
    a_n, c_n, _ = interchange_from_streams(streams, C.shape[0] // 8)
    equal(A, a_n, "416x240 region A vs native")
    equal(C, c_n, "416x240 region C vs native")
    y, u, v, dok = ds.decompress_frame(A, C, sizes, *qts, h=h, w=w)
    check(bool(dok), "416x240 decompress ok")
    for i, (got, want) in enumerate(zip((y, u, v),
                                        native_decode(streams, 50, h, w))):
        equal(got, want, f"416x240 plane {i}")
    # the cont ladder: q95 noise overflows the 64-byte tier and must climb
    q = 95
    qts_np = qtables(q)
    qts95 = [jnp.asarray(t) for t in qts_np]
    *_, ok8 = ds.compress_frame(*[jnp.asarray(p) for p in noise], *qts95,
                                cont=ds.CONT_DEFAULT)
    check(not bool(ok8), "q95 noise should overflow the default tier")
    stats = {}
    got = ds.compress_frame_to_streams(noise, qts_np, stats=stats)
    check(stats["cont"] > ds.CONT_DEFAULT, f"ladder did not climb: {stats}")
    for i, ((gs, gc), (ws, wc)) in enumerate(zip(got,
                                                 native_streams(noise, q))):
        equal(gs, ws, f"ladder plane {i} sizes")
        equal(gc, wc, f"ladder plane {i} content")
    log(f"  ladder climbed to cont={stats['cont']}")
    # a q50 natural frame must stay on the device (no host fallback)
    stats = {}
    nat = synthetic.natural_planes(H4K, W4K, seed=11)
    got = ds.compress_frame_to_streams(nat, qtables(50), stats=stats)
    check(stats["cont"] == ds.CONT_DEFAULT, f"q50 left the default tier "
          f"{stats}")
    for i, ((gs, gc), (ws, wc)) in enumerate(zip(got,
                                                 native_streams(nat, 50))):
        equal(gc, wc, f"q50 streams plane {i} content")


def phase_four_cards(devs):
    """Sharded word contract and sharded plane pipeline on a 4-card mesh,
    byte for byte against the one-card results."""
    import jax
    import jax.numpy as jnp
    from myyuv_tpu.engine import batch as eb
    from myyuv_tpu.engine import device_stream as ds
    from myyuv_tpu.engine import sharded_stream as ss
    from myyuv_tpu.engine import word_frame as wf
    from myyuv_tpu.parallel import mesh as meshlib
    from myyuv_tpu.runtime import synthetic
    mesh = meshlib.make_mesh((1, 4), devs[:4])
    h, w = H4K, W4K
    planes = synthetic.natural_planes(h, w, seed=21)
    qts = eb.plane_qtables([50] * 3)
    xw = wf.pack_frame(*[jnp.asarray(p) for p in planes])
    A1, C1, s1, t1, ok1 = wf.compress_words(xw, *qts, h=h, w=w)
    x1, dok1 = wf.decompress_words(A1, C1, s1, *qts, h=h, w=w)
    check(bool(ok1) and bool(dok1), "one-card word roundtrip ok")
    xws = wf.pad_frame_cols(xw, 4)
    A, C, s, t, ok = wf.compress_words_sharded(mesh, xws, *qts, h=h, w=w)
    check(bool(ok), "sharded compress_words ok")
    holders = {sh.device for sh in A.addressable_shards}
    check(len(holders) == 4, f"A lives on {len(holders)} devices, not 4")
    n8 = A1.shape[1]
    equal(s, s1, "sharded sizes vs one card")
    check(int(t) == int(t1), "sharded total vs one card")
    equal(np.asarray(A)[:, :n8], A1, "sharded region A vs one card")
    equal(np.asarray(C)[:, :n8], C1, "sharded region C vs one card")
    x, dok = wf.decompress_words_sharded(mesh, A, C, s, *qts, h=h, w=w)
    check(bool(dok), "sharded decompress_words ok")
    check(len({sh.device for sh in x.addressable_shards}) == 4,
          "sharded frame not on 4 devices")
    for i, (a, b) in enumerate(zip(wf.unpack_frame(x, h, w),
                                   wf.unpack_frame(x1, h, w))):
        equal(a, b, f"sharded word plane {i} vs one card")
    qts_np = qtables(50)
    one = ds.compress_frame_to_streams(planes, qts_np)
    shard = ss.compress_frame_sharded(mesh, planes, qts_np)
    for i, ((gs, gc), (ws, wc)) in enumerate(zip(shard, one)):
        equal(gs, ws, f"sharded_stream plane {i} sizes vs one card")
        equal(gc, wc, f"sharded_stream plane {i} content vs one card")
    rec1 = ds.decompress_streams_to_frame(one, qts_np, h, w)
    rec = ss.decompress_frame_sharded(mesh, shard, qts_np, h, w)
    for i, (a, b) in enumerate(zip(rec, rec1)):
        equal(a, b, f"sharded_stream decoded plane {i} vs one card")
    jax.block_until_ready(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phase on a 4-card mesh")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1

    import jax
    from myyuv_tpu.runtime import jaxcache, synthetic
    jaxcache.enable()
    t0 = time.perf_counter()
    with Phase("device"):
        devs = phase_device(count)
    if args.four_cards:
        with Phase("four cards: sharded codec"):
            phase_four_cards(devs)
    else:
        with Phase("content"):
            bgrx = [synthetic.natural_bgrx(H4K, W4K, seed=k)
                    for k in range(8)]
            from myyuv_tpu.kernels import scalar
            natural = scalar.bgrx_to_iyuv(bgrx[0])
            noise = synthetic.noise_planes(H4K, W4K, seed=1)
        with Phase("transform"):
            phase_transform(natural)
        with Phase("kernels"):
            phase_kernels(natural, noise)
        with tempfile.TemporaryDirectory() as tmp:
            with Phase("main path: cli"):
                phase_cli(bgrx[0], Path(tmp))
        with Phase("main path: word contract x8"):
            phase_words(bgrx)
        with Phase("main path: batch"):
            phase_batch()
        with Phase("main path: 416x240 + ladder"):
            phase_small_and_ladder(noise)
    log(f"all phases ok in {time.perf_counter() - t0:.1f} s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
