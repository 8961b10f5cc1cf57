"""Capture an xplane trace of the steady-state bench loop."""
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

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
    for i in range(12):
        gray, depth = data["frames"][i]
        sysm.track_rgbd(gray, depth, i / 30.0)
    sysm.tracker.flush()
    jax.block_until_ready(sysm.map)
    with jax.profiler.trace("/tmp/slam_trace"):
        for i in range(12, 24):
            gray, depth = data["frames"][i]
            sysm.track_rgbd(gray, depth, i / 30.0)
        sysm.tracker.flush()
        jax.block_until_ready(sysm.map)
    print("trace done, kfs:", sysm.n_keyframes)


if __name__ == "__main__":
    main()
