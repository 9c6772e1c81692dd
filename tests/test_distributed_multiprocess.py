"""Two-process jax.distributed test: the multi-process branches of
parallel/distributed.py (initialize, allgather_sizes, gather_streams)
execute for real — two CPU processes compress disjoint halves of one
plane and both assemble the identical global stream."""

import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

_WORKER = r"""
import hashlib, json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

port, pid = sys.argv[1], int(sys.argv[2])
from myyuv_tpu.parallel import distributed as dist
dist.initialize(f"localhost:{port}", num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()

from myyuv_tpu import entropy
from myyuv_tpu.kernels import scalar

h, w = 32, 64
yy, xx = np.mgrid[0:h, 0:w]
plane = (128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(np.uint8)
qt = scalar.plane_qtable(0, 50)
coeffs = scalar.dct_quantize_blocks(
    scalar.plane_to_blocks(plane), qt).reshape(-1, 64)
lo, hi = dist.local_shard(coeffs.shape[0])
sizes, content = entropy.encode_blocks(coeffs[lo:hi])

all_sizes = dist.allgather_sizes(sizes)
gsizes, gcontent = dist.gather_streams(sizes, content)
offs = dist.global_offsets(all_sizes)
print(json.dumps({
    "pid": pid,
    "n_hosts": len(all_sizes),
    "offsets": [int(o) for o in offs],
    "n_blocks": int(gsizes.size),
    "sha": hashlib.sha256(gcontent.tobytes()).hexdigest(),
}), flush=True)
"""


def test_two_process_gather_streams(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:" + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(port), str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        text=True) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))

    # both processes saw 2 hosts and assembled the identical global stream
    assert {o["pid"] for o in outs} == {0, 1}
    assert all(o["n_hosts"] == 2 for o in outs)
    assert outs[0]["sha"] == outs[1]["sha"]
    assert outs[0]["offsets"] == outs[1]["offsets"]
    assert outs[0]["offsets"][0] == 0 and outs[0]["offsets"][1] > 0

    # and it matches the single-process encode of the whole plane
    from myyuv_tpu import entropy
    from myyuv_tpu.kernels import scalar
    h, w = 32, 64
    yy, xx = np.mgrid[0:h, 0:w]
    plane = (128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(np.uint8)
    qt = scalar.plane_qtable(0, 50)
    coeffs = scalar.dct_quantize_blocks(
        scalar.plane_to_blocks(plane), qt).reshape(-1, 64)
    sizes, content = entropy.encode_blocks(coeffs)
    assert outs[0]["n_blocks"] == sizes.size
    assert outs[0]["sha"] == hashlib.sha256(content.tobytes()).hexdigest()


_WORKER4 = r"""
import hashlib, json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

port, pid = sys.argv[1], int(sys.argv[2])
from myyuv_tpu.parallel import distributed as dist
dist.initialize(f"localhost:{port}", num_processes=4, process_id=pid)
assert jax.process_count() == 4, jax.process_count()

from myyuv_tpu import entropy
from myyuv_tpu.kernels import scalar

# 24x24 = NINE blocks over FOUR processes: per-host share is 3, so
# process 3's shard is EMPTY — the ragged-gather contract must carry
# zero-length sizes/content segments (uneven + empty shards pin
# gather_streams/global_offsets beyond the 2-process case)
h, w = 24, 24
yy, xx = np.mgrid[0:h, 0:w]
plane = (128 + 60 * np.sin(xx / 3.1) * np.cos(yy / 2.3)).astype(np.uint8)
qt = scalar.plane_qtable(0, 50)
coeffs = scalar.dct_quantize_blocks(
    scalar.plane_to_blocks(plane), qt).reshape(-1, 64)
lo, hi = dist.local_shard(coeffs.shape[0])
if hi > lo:
    sizes, content = entropy.encode_blocks(coeffs[lo:hi])
else:
    sizes = np.zeros(0, np.uint8)
    content = np.zeros(0, np.uint8)

all_sizes = dist.allgather_sizes(sizes)
gsizes, gcontent = dist.gather_streams(sizes, content)
offs = dist.global_offsets(all_sizes)
print(json.dumps({
    "pid": pid,
    "local_n": int(hi - lo),
    "n_hosts": len(all_sizes),
    "offsets": [int(o) for o in offs],
    "n_blocks": int(gsizes.size),
    "sha": hashlib.sha256(gcontent.tobytes()).hexdigest(),
}), flush=True)
"""


def test_four_process_uneven_empty_shards(tmp_path):
    """4 CPU processes, 9 blocks: shares 3/3/3/0 — the ragged gather
    must reproduce the single-process stream with an EMPTY tail shard,
    and every host must agree on offsets."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker4.py"
    worker.write_text(_WORKER4)
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:" + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(port), str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        text=True) for i in range(4)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=200)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))

    assert {o["pid"] for o in outs} == {0, 1, 2, 3}
    assert sorted(o["local_n"] for o in outs) == [0, 3, 3, 3]
    assert all(o["n_hosts"] == 4 for o in outs)
    assert len({o["sha"] for o in outs}) == 1
    assert len({tuple(o["offsets"]) for o in outs}) == 1
    offs = outs[0]["offsets"]
    from myyuv_tpu import entropy
    from myyuv_tpu.kernels import scalar
    h, w = 24, 24
    yy, xx = np.mgrid[0:h, 0:w]
    plane = (128 + 60 * np.sin(xx / 3.1)
             * np.cos(yy / 2.3)).astype(np.uint8)
    qt = scalar.plane_qtable(0, 50)
    coeffs = scalar.dct_quantize_blocks(
        scalar.plane_to_blocks(plane), qt).reshape(-1, 64)
    sizes, content = entropy.encode_blocks(coeffs)
    assert outs[0]["n_blocks"] == 9 == sizes.size
    assert outs[0]["sha"] == hashlib.sha256(content.tobytes()).hexdigest()
    # offsets: exclusive prefix of the three live hosts, empty tail flat
    per = [int(s.astype(np.int64).sum()) for s in
           (sizes[0:3], sizes[3:6], sizes[6:9])]
    assert offs == [0, per[0], per[0] + per[1], sum(per)]


_WORKER_BATCH = r"""
import hashlib, json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

port, pid = sys.argv[1], int(sys.argv[2])
from myyuv_tpu.parallel import distributed as dist
dist.initialize(f"localhost:{port}", num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()

from myyuv_tpu.engine import sharded_stream as ss
from myyuv_tpu.kernels import scalar
from myyuv_tpu.parallel import mesh as meshlib

# frames are data-parallel ACROSS processes; within each process the
# flagship codec shards block rows over the process-LOCAL mesh
mesh = meshlib.make_mesh((len(jax.local_devices()), 1),
                         jax.local_devices())

h, w, b = 32, 64, 4
yy, xx = np.mgrid[0:h, 0:w]
base = (128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(np.uint8)
ys = np.stack([(base + f) for f in range(b)]).astype(np.uint8)
us = np.stack([base[:h // 2, :w // 2] + f for f in range(b)]).astype(np.uint8)
vs = np.stack([base[h // 2:, :w // 2] + f for f in range(b)]).astype(np.uint8)
qts = [np.asarray(scalar.plane_qtable(i, 50), np.float32) for i in range(3)]

frames = ss.compress_batch_sharded(mesh, (ys, us, vs), qts)
blob = b"".join(bytes(c) + bytes(s) for streams in frames
                for s, c in streams)
print(json.dumps({
    "pid": pid,
    "n_frames": len(frames),
    "sha": hashlib.sha256(blob).hexdigest(),
}), flush=True)
"""


def test_two_process_sharded_batch(tmp_path):
    """shard_batch -> sharded flagship compress -> gather_streams across
    two real processes: both assemble identical per-frame streams that
    match the host coder's."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker_batch.py"
    worker.write_text(_WORKER_BATCH)
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:" + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(port), str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        text=True) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))

    assert all(o["n_frames"] == 4 for o in outs)
    assert outs[0]["sha"] == outs[1]["sha"]

    # identical to the single-process host coder, frame by frame
    import hashlib as hl
    from myyuv_tpu import entropy
    from myyuv_tpu.kernels import scalar
    h, w, b = 32, 64, 4
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(np.uint8)
    ys = np.stack([(base + f) for f in range(b)]).astype(np.uint8)
    us = np.stack([base[:h // 2, :w // 2] + f
                   for f in range(b)]).astype(np.uint8)
    vs = np.stack([base[h // 2:, :w // 2] + f
                   for f in range(b)]).astype(np.uint8)
    qts = [np.asarray(scalar.plane_qtable(i, 50), np.float32)
           for i in range(3)]
    blob = b""
    for f in range(b):
        for p, plane in enumerate((ys[f], us[f], vs[f])):
            co = scalar.dct_quantize_blocks(
                scalar.plane_to_blocks(plane), qts[p])
            sizes, content = entropy.encode_blocks(
                co.reshape(-1, 64).astype(np.int16))
            blob += bytes(content) + bytes(sizes.astype(np.uint8))
    assert outs[0]["sha"] == hl.sha256(blob).hexdigest()
