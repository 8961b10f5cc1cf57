"""Blocking per-frame timing of the bench workload: where do the ms go?

Per-frame block_until_ready destroys pipelining, so absolute fps here is
pessimistic — but the per-frame histogram shows exactly which frames
(keyframe-mapping steps, loop-closer keyframes) cost what.
"""
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
import jax.numpy as jnp
import numpy as np

import bench as bench_mod
from orbslam_mapsave_tpu import config as config_mod
from orbslam_mapsave_tpu.pipeline import system as system_mod

data = bench_mod.get_sequence()
use_loop = not os.environ.get("BENCH_NO_LOOP")
voc = bench_mod.get_vocabulary(data, config_mod, system_mod) if use_loop else None
slam = bench_mod.make_system(voc, config_mod, system_mod)
frames_dev = [(jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
              for g, d in data["frames"]]
jax.block_until_ready(frames_dev)
N = len(frames_dev)

# warmup
for i in range(12):
    g, d = frames_dev[i]
    slam.track_rgbd(g, d, 1000.0 + i / 30.0)
slam.tracker.flush()
slam.reset()

rows = []
for i in range(N):
    g, d = frames_dev[i]
    t0 = time.perf_counter()
    pose = slam.track_rgbd(g, d, 1000.0 + i / 30.0)
    jax.block_until_ready(pose)
    t1 = time.perf_counter()
    rows.append((i, 1e3 * (t1 - t0)))
slam.tracker.flush()

ms = np.array([m for _, m in rows])
print(f"frames={N} total={ms.sum()/1e3:.2f}s median={np.median(ms):.2f}ms "
      f"p90={np.percentile(ms, 90):.1f} p99={np.percentile(ms, 99):.1f}")
order = np.argsort(-ms)[:20]
for j in order:
    print(f"  frame {rows[j][0]:3d}: {rows[j][1]:8.1f} ms")
print("kfs", slam.n_keyframes, "pts", slam.n_points,
      "loops", len(slam.loop_closer.events) if slam.loop_closer else 0)
