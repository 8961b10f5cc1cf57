"""Round-3 perf itemization: one pass over the bench workload, per-frame
wall times bucketed by phase (tracker enqueue, backend loop-closer, GBA),
plus KF vs non-KF frame split. Warm persistent cache assumed."""
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
voc = bench_mod.get_vocabulary(data, config_mod, system_mod)
frames_dev = [(jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
              for g, d in data["frames"]]
jax.block_until_ready(frames_dev)
N = len(frames_dev)

slam = bench_mod.make_system(voc, config_mod, system_mod)
lc = slam.loop_closer

t_track = np.zeros(N)
t_backend = np.zeros(N)
kf_frames = []

# warmup pass (compile everything)
t0 = time.perf_counter()
for i in range(N):
    g, d = frames_dev[i]
    slam.track_rgbd(g, d, 1000.0 + i / 30.0)
slam.tracker.flush()
slam.flush_gba()
print(f"warmup pass: {time.perf_counter()-t0:.1f}s", flush=True)
slam.reset()

orig_run = slam._run_backends

def timed_run():
    orig_run()

slam._run_backends = lambda: None  # we call backend separately

t0 = time.perf_counter()
for i in range(N):
    g, d = frames_dev[i]
    tt = time.perf_counter()
    slam.tracker.track_rgbd(g, d, 1000.0 + i / 30.0)
    t_track[i] = time.perf_counter() - tt
    tt = time.perf_counter()
    orig_run()
    t_backend[i] = time.perf_counter() - tt
slam.tracker.flush()
tg = time.perf_counter()
slam.flush_gba()
t_gba = time.perf_counter() - tg
total = time.perf_counter() - t0

print(f"total={total:.2f}s  track(enqueue)={t_track.sum():.2f}s  "
      f"backend={t_backend.sum():.2f}s  final_flush_gba={t_gba:.2f}s")
print(f"track per-frame: p50={np.percentile(t_track,50)*1e3:.1f}ms "
      f"p90={np.percentile(t_track,90)*1e3:.1f}ms "
      f"p99={np.percentile(t_track,99)*1e3:.1f}ms max={t_track.max()*1e3:.1f}ms")
print(f"backend per-frame: p50={np.percentile(t_backend,50)*1e3:.1f}ms "
      f"p90={np.percentile(t_backend,90)*1e3:.1f}ms max={t_backend.max()*1e3:.1f}ms")
# top-10 slowest frames
order = np.argsort(-(t_track + t_backend))[:12]
for i in order:
    print(f"  frame {i:3d}: track={t_track[i]*1e3:7.1f}ms backend={t_backend[i]*1e3:7.1f}ms")
print("kfs", slam.n_keyframes, "pts", slam.n_points, "loops", len(lc.events))
