"""Benchmark of the codec on one NVIDIA GPU.

Prints ONE JSON line naming the device it ran on (platform, kind, count,
and the card's name and power limit from nvidia-smi) and:

  kernels  — for 3840x2160 frames at q50 and q90, each implementation of
             the word-frame codec kernels (kernels/codec: "ffi" = the
             CUDA kernels, "xla" = plain JAX): device time of the
             compress and decompress executables from a profiler trace,
             wall time of the whole ``roundtrip_words``, and a check that
             both implementations agree byte for byte;
  frame    — the plane-contract 4K roundtrip (engine/device_stream
             .roundtrip_frame: pack + kernels + unpack), wall and device;
  streamed — sustained word-contract roundtrips with frames in flight
             (engine/streaming.sustained_word_fps);
  batch    — a B=8 1920x1088 batch per executable (compress_batch +
             decompress_batch), wall per frame;
  conv     — the BGRX<->IYUV conversion kernels, device time, bit-exact
             against kernels/scalar;
  cpu      — the fused native C++ codec on the host, for scale.

Content is seeded (runtime/synthetic.natural_planes). Wall time: median
of REPS calls, each ending in ``block_until_ready``, after a warm-up call.
Device time: runtime/devtrace over a traced window of 10 calls.

Runs only where JAX finds a GPU; elsewhere it exits with status 2.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

H4K, W4K = 2160, 3840
H1080, W1080 = 1088, 1920          # 1080p padded to the codec's 16-multiple
BATCH_B = 8
REPS = int(os.environ.get("MYYUV_BENCH_REPS", "20"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def wall_ms(fn, reps=REPS):
    """Median wall ms of ``fn`` (each call ends in block_until_ready)."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def device_ms(fn, named=()):
    from myyuv_tpu.runtime import devtrace
    s = devtrace.trace(fn, reps=10, named=named)
    top = dict(list(s["kernel_ms"].items())[:6])
    return {"busy_ms": s["busy_ms"], "kernel_ms": top}


def bench_kernels(planes, q):
    """Both codec implementations on one 4K frame at quality q."""
    import jax.numpy as jnp
    from myyuv_tpu.engine import batch as eb
    from myyuv_tpu.engine import device_stream as ds
    from myyuv_tpu.engine import word_frame as wf
    from myyuv_tpu.kernels import codec

    h, w = planes[0].shape
    qts = eb.plane_qtables([q] * 3)
    cont = ds.cont_for_quality(q) or ds.CONT_DEFAULT
    xw = wf.pack_frame(*[jnp.asarray(p) for p in planes])
    out, outs = {}, {}
    for impl in codec.IMPLS:
        enc = lambda: wf.compress_words(xw, *qts, h=h, w=w, cont=cont,
                                        impl=impl)
        A, C, sizes, total, ok = enc()
        dec = lambda: wf.decompress_words(A, C, sizes, *qts, h=h, w=w,
                                          impl=impl)
        rxw, dok = dec()
        rt = lambda: wf.roundtrip_words(xw, *qts, h=h, w=w, cont=cont,
                                        impl=impl)
        outs[impl] = [np.asarray(x) for x in (A, C, sizes, rxw)]
        named = ("encode_kernel", "decode_kernel")
        out[impl] = {
            "ok": bool(ok) and bool(dok),
            "compress_device": device_ms(enc, named),
            "decompress_device": device_ms(dec, named),
            "roundtrip_wall_ms": wall_ms(rt),
            "roundtrip_device_busy_ms": device_ms(rt)["busy_ms"],
        }
        log(f"q{q} {impl}: compress {out[impl]['compress_device']['busy_ms']:.3f}"
            f" ms, decompress {out[impl]['decompress_device']['busy_ms']:.3f}"
            f" ms device; roundtrip {out[impl]['roundtrip_wall_ms']:.3f} ms "
            f"wall")
    out["impls_agree"] = all(
        np.array_equal(a, b) for a, b in zip(outs["ffi"], outs["xla"]))
    out["compressed_bytes"] = int(outs["ffi"][2].astype(np.int64).sum())
    out["cont"] = cont
    return out


def bench_frame(planes):
    import jax.numpy as jnp
    from myyuv_tpu.engine import batch as eb
    from myyuv_tpu.engine import device_stream as ds
    qts = eb.plane_qtables([50] * 3)
    dev = [jnp.asarray(p) for p in planes]
    rt = lambda: ds.roundtrip_frame(*dev, *qts)
    return {"wall_ms": wall_ms(rt), "device": device_ms(rt)}


def bench_streamed(planes):
    from myyuv_tpu.engine import batch as eb
    from myyuv_tpu.engine import streaming
    fps, ok, _total, stats = streaming.sustained_word_fps(
        planes, eb.plane_qtables([50] * 3))
    return {"fps": fps, "ok": ok, "windows": stats}


def bench_batch():
    import jax.numpy as jnp
    from myyuv_tpu.engine import batch as eb
    from myyuv_tpu.engine import device_stream as ds
    from myyuv_tpu.runtime import synthetic
    frames = [synthetic.natural_planes(H1080, W1080, seed=200 + f)
              for f in range(BATCH_B)]
    y, u, v = [jnp.asarray(np.stack([fr[i] for fr in frames]))
               for i in range(3)]
    qts = eb.plane_qtables([50] * 3)

    def rt():
        A, C, sizes, total, ok = ds.compress_batch(y, u, v, *qts)
        return ds.decompress_batch(A, C, sizes, *qts, b=BATCH_B, h=H1080,
                                   w=W1080)

    ms = wall_ms(rt)
    return {"frames": BATCH_B, "ms_per_frame": ms / BATCH_B,
            "ok": bool(rt()[3])}


def bench_conversions(planes):
    import jax
    import jax.numpy as jnp
    from myyuv_tpu.kernels import device as kdev
    from myyuv_tpu.kernels import scalar
    from myyuv_tpu.runtime import synthetic
    bgrx = synthetic.natural_bgrx(H4K, W4K, seed=3)
    fwd, inv = jax.jit(kdev.bgrx_to_iyuv), jax.jit(kdev.iyuv_to_bgrx)
    bdev = jnp.asarray(bgrx)
    pdev = [jnp.asarray(p) for p in planes]
    exact = all(np.array_equal(np.asarray(a), b) for a, b in
                zip(fwd(bdev), scalar.bgrx_to_iyuv(bgrx)))
    exact = exact and np.array_equal(np.asarray(inv(*pdev)),
                                     scalar.iyuv_to_bgrx(*planes))
    return {"bit_exact": bool(exact),
            "bgrx_to_iyuv_device_ms": device_ms(lambda: fwd(bdev))["busy_ms"],
            "iyuv_to_bgrx_device_ms": device_ms(lambda: inv(*pdev))["busy_ms"]}


def bench_cpu(planes):
    from myyuv_tpu import native
    from myyuv_tpu.kernels import constants
    qts = [constants.quality_scaled_qtable(constants.PLANE_Q50[i], 50)
           for i in range(3)]

    def rt():
        streams = [native.compress_plane(p, q) for p, q in zip(planes, qts)]
        return [native.decompress_plane(s, c, q, *p.shape)
                for (s, c), q, p in zip(streams, qts, planes)]

    rt()
    t0 = time.perf_counter()
    for _ in range(3):
        rt()
    return {"roundtrip_ms": (time.perf_counter() - t0) / 3 * 1e3,
            "threads": native._default_threads()}


def main() -> int:
    from myyuv_tpu.runtime import backend, jaxcache
    jaxcache.enable()
    import jax
    if backend.platform() != "gpu":
        log("bench.py measures the GPU; JAX found none")
        return 2
    from myyuv_tpu.runtime import synthetic

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    d = jax.devices()[0]
    log("device:", d.device_kind, "|", smi)
    planes = synthetic.natural_planes(H4K, W4K, seed=0)
    result = {
        "metric": "4k_dct50_word_roundtrips_per_sec",
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices()), "nvidia_smi": smi},
        "kernels": {f"q{q}": bench_kernels(planes, q) for q in (50, 90)},
    }
    k50 = result["kernels"]["q50"]["ffi"]
    result["value"] = 1e3 / k50["roundtrip_wall_ms"]
    result["unit"] = "frames/s"
    for name, fn in (("frame", lambda: bench_frame(planes)),
                     ("streamed", lambda: bench_streamed(planes)),
                     ("batch_1080p", bench_batch),
                     ("conversions", lambda: bench_conversions(planes)),
                     ("cpu_native", lambda: bench_cpu(planes))):
        result[name] = fn()
        log(name, result[name])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
