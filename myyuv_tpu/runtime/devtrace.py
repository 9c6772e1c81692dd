"""Device time from a ``jax.profiler`` trace of the GPU.

``trace(fn, reps)`` runs ``fn`` ``reps`` times under the profiler (after
one untraced warm-up call) and reduces the trace to per-rep numbers:

* ``busy_ms`` — the union of the intervals in which any kernel or copy
  ran on the GPU's streams, per rep;
* ``kernel_ms`` — the summed device duration of each kernel name, per
  rep (``named`` folds names containing a given substring together).

Only GPU device planes (``/device:GPU:*``) and their stream lines are
read; a trace with no GPU events is an error, never a zero.

Read an existing trace: ``python -m myyuv_tpu.runtime.devtrace
<file.xplane.pb> [top_n]``.
"""

from __future__ import annotations

import collections
import glob
import sys
import tempfile


def gpu_events(pb_path: str):
    """[(name, start_ns, duration_ns)] of every event on a GPU stream."""
    import jax

    data = jax.profiler.ProfileData.from_file(pb_path)
    out = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            out += [(e.name, e.start_ns, e.duration_ns) for e in line.events]
    return out


def summarize(events, reps: int = 1, named=()) -> dict:
    """Reduce stream events to per-rep busy and per-kernel device ms."""
    if not events:
        raise RuntimeError("trace holds no GPU events")
    per = collections.Counter()
    for name, _, dur in events:
        key = next((n for n in named if n in name), name)
        per[key] += dur
    busy = 0
    end = None
    for _, start, dur in sorted(events, key=lambda e: e[1]):
        stop = start + dur
        if end is None or start >= end:
            busy += dur
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return {"busy_ms": busy / reps / 1e6,
            "kernel_ms": {k: v / reps / 1e6 for k, v in per.most_common()}}


def trace(fn, reps: int = 10, named=()):
    """Profile ``reps`` calls of ``fn`` (after one warm-up) -> summary."""
    import jax

    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(reps):
                out = fn()
            jax.block_until_ready(out)
        pb = sorted(glob.glob(f"{d}/plugins/profile/*/*.xplane.pb"))[-1]
        return summarize(gpu_events(pb), reps, named)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    top = int(argv[1]) if len(argv) > 1 else 20
    s = summarize(gpu_events(argv[0]))
    print(f"busy {s['busy_ms']:.3f} ms")
    for name, ms in list(s["kernel_ms"].items())[:top]:
        print(f"{ms:10.3f} ms  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
