"""Per-stage wall timing of the tracking pipeline on the bench sequence."""
import os
import sys
import time
from collections import defaultdict
from pathlib import Path


sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
import numpy as np

import bench as bench_mod

TIMES = defaultdict(list)


def timed(name, fn):
    def wrap(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        jax.block_until_ready(out)
        TIMES[name].append(time.perf_counter() - t0)
        return out
    return wrap


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
    # wrap tracking kernels
    for name in list(sysm.tracker.k.keys()):
        sysm.tracker.k[name] = timed("trk." + name, sysm.tracker.k[name])
    # wrap frame builder
    sysm.builder.build = timed("frame.build", sysm.builder.build)
    # wrap mapper process
    sysm.mapper.process = timed("map.process", sysm.mapper.process)

    per_frame = []
    for i, (gray, depth) in enumerate(data["frames"]):
        t0 = time.perf_counter()
        sysm.track_rgbd(gray, depth, i / 30.0)
        per_frame.append(time.perf_counter() - t0)

    print(f"frames: {len(per_frame)}  total {sum(per_frame):.2f}s")
    print(f"median frame: {np.median(per_frame[8:])*1e3:.1f} ms")
    print(f"{'stage':30s} {'calls':>5s} {'total_s':>8s} {'med_ms':>8s} {'max_ms':>8s}")
    for name, ts in sorted(TIMES.items(), key=lambda kv: -sum(kv[1])):
        ts_post = ts[8:] if len(ts) > 12 else ts
        print(f"{name:30s} {len(ts):5d} {sum(ts):8.2f} "
              f"{np.median(ts_post)*1e3:8.1f} {max(ts_post)*1e3:8.1f}")


if __name__ == "__main__":
    main()
