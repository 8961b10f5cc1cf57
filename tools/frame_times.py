"""Per-frame host wall-time profile of the bench loop: find the spikes."""
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



def main():
    data = bench_mod.get_sequence()
    voc = bench_mod.get_vocabulary(data, config_mod, system_mod)
    slam = bench_mod.make_system(voc, config_mod, system_mod)
    N = bench_mod.N_FRAMES
    frames_dev = [(jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
                  for g, d in data["frames"]]
    jax.block_until_ready(frames_dev)
    for i in range(N):
        g, d = frames_dev[i]
        slam.track_rgbd(g, d, 1000.0 + i / 30.0)
    slam.tracker.flush()
    slam.flush_gba()
    slam.reset()

    times = np.zeros(N)
    t0 = time.perf_counter()
    for i in range(N):
        g, d = frames_dev[i]
        t1 = time.perf_counter()
        slam.track_rgbd(g, d, 1000.0 + i / 30.0)
        times[i] = time.perf_counter() - t1
    tf0 = time.perf_counter()
    slam.tracker.flush()
    t_flush = time.perf_counter() - tf0
    tf0 = time.perf_counter()
    slam.flush_gba()
    t_gba = time.perf_counter() - tf0
    total = time.perf_counter() - t0
    order = np.argsort(times)[::-1]
    print(f"total={total:.2f}s  final flush={t_flush*1e3:.0f}ms  "
          f"flush_gba={t_gba*1e3:.0f}ms  loops={len(slam.loop_closer.events)}")
    print("slowest frames:")
    for i in order[:18]:
        print(f"  frame {i:3d}: {times[i]*1e3:8.1f} ms")
    print(f"sum of rest: {times[order[18:]].sum():.2f}s "
          f"median={np.median(times)*1e3:.2f}ms")
    # histogram of per-frame host time
    for th in (5, 10, 20, 50, 100, 200, 500):
        print(f"  frames >{th}ms: {(times*1e3 > th).sum()}")


if __name__ == "__main__":
    main()
