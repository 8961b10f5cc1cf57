"""Per-frame wall time distribution on the bench sequence, synced per frame."""
import os
import sys
import time
from pathlib import Path


sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
import numpy as np

import bench as bench_mod


def main():
    data = bench_mod.get_sequence()
    from orbslam_mapsave_tpu import config as config_mod
    from orbslam_mapsave_tpu.pipeline import system as system_mod

    W, H = bench_mod.W, bench_mod.H
    cfg = config_mod.SystemConfig()
    cfg.camera = config_mod.CameraConfig(
        fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, width=W, height=H,
        fps=30, bf=40.0, th_depth=40.0,
    )
    sysm = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD,
                                 enable_loop_closing=False)
    times = []
    kfs_at = []
    for i in range(bench_mod.N_FRAMES):
        gray, depth = data["frames"][i]
        t0 = time.perf_counter()
        sysm.track_rgbd(gray, depth, i / 30.0)
        jax.block_until_ready(sysm.map)
        dt = time.perf_counter() - t0
        times.append(dt * 1000)
        kfs_at.append(len(sysm.tracker.new_kf_slots))
    sysm.tracker.flush()
    times = np.array(times[6:])  # skip warmup/compile frames
    print(f"kfs={sysm.n_keyframes} pts={sysm.n_points}")
    print(f"median={np.median(times):.1f}ms  mean={np.mean(times):.1f}  "
          f"p90={np.percentile(times, 90):.1f}  max={np.max(times):.1f}")
    print("frames ms:", " ".join(f"{t:.0f}" for t in times))


if __name__ == "__main__":
    main()
