"""Split per-frame cost: frame build vs fused step vs dispatch overhead."""
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
W, H = bench_mod.W, bench_mod.H
cfg = config_mod.SystemConfig()
cfg.camera = config_mod.CameraConfig(
    fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, width=W, height=H,
    bf=520.0 * 0.08, th_depth=50.0, fps=30,
)
cfg.orb = config_mod.ORBConfig(n_features=2000, n_levels=4, scale_factor=1.5)
cfg.max_keypoints = 2048
cfg.max_keyframes = 64
cfg.max_points = 16384
slam = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD,
                             enable_loop_closing=False)
cfg.max_points = 32768

frames_dev = [(jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
              for g, d in data["frames"]]
jax.block_until_ready(frames_dev)
N = len(frames_dev)

# warmup everything
for i in range(6):
    g, d = frames_dev[i]
    slam.track_rgbd(g, d, 1000.0 + i / 30.0)
slam.tracker.flush()

# 1) builder.build alone, pipelined
builds = []
t0 = time.perf_counter()
for g, d in frames_dev:
    builds.append(slam.builder.build(g, 0.0, d))
jax.block_until_ready(builds[-1])
t_build = time.perf_counter() - t0
print(f"build alone:  {1e3*t_build/N:.2f} ms/frame  ({N/t_build:.1f} fps)")

# 2) fused step alone on a fixed frame, pipelined
fr = builds[10]
state, ctrl = slam.tracker.map, slam.tracker.ctrl
step = slam.tracker.step
outs = []
s, c = state, ctrl
t0 = time.perf_counter()
for i in range(N):
    s, c, out = step(s, c, fr)
    outs.append(out)
jax.block_until_ready(outs[-1])
t_step = time.perf_counter() - t0
print(f"step alone:   {1e3*t_step/N:.2f} ms/frame  ({N/t_step:.1f} fps)")

# 3) trivial no-op dispatch latency estimate
f = jax.jit(lambda x: x + 1.0)
x = jnp.zeros((8, 128))
x = f(x)
jax.block_until_ready(x)
t0 = time.perf_counter()
for i in range(100):
    x = f(x)
jax.block_until_ready(x)
print(f"noop chain:   {1e3*(time.perf_counter()-t0)/100:.3f} ms/call")

# 4) build stage breakdown: extraction vs stereo-depth/undistort parts
from orbslam_mapsave_tpu.ops import orb
ext = orb.make_extractor(slam.spec)
r = ext(frames_dev[0][0])
jax.block_until_ready(r)
t0 = time.perf_counter()
rs = []
for g, d in frames_dev:
    rs.append(ext(g))
jax.block_until_ready(rs[-1])
t_ext = time.perf_counter() - t0
print(f"extract only: {1e3*t_ext/N:.2f} ms/frame")
