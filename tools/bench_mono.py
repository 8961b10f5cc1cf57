"""Monocular bench on the real chip (VERDICT r4 #5: mono had no on-chip
perf story; the reference treats mono as co-equal, `src/Tracking.cc:
804-880`). Same operating point as the headline RGB-D bench (640x480,
2000 features, loop closing ON, H/F two-view bootstrap, 7-DoF fix_scale=
False Sim3 loop), gray channel only. Records fps + Sim3-aligned keyframe
ATE (mono scale is free) into docs/BENCH_MONO.json."""
import json
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
from orbslam_mapsave_tpu.io import trajectory as traj_io
from orbslam_mapsave_tpu.pipeline import system as system_mod

W, H = bench_mod.W, bench_mod.H
N_FRAMES = bench_mod.N_FRAMES


def make_mono_system(voc):
    cfg = config_mod.SystemConfig()
    cfg.camera = config_mod.CameraConfig(
        fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, width=W, height=H,
        bf=520.0 * 0.08, th_depth=50.0, fps=30,
    )
    cfg.orb = config_mod.ORBConfig(n_features=2000, n_levels=4,
                                   scale_factor=1.5)
    cfg.max_keypoints = 2048
    cfg.max_keyframes = 96  # mono culls harder; headroom for the allocator
    cfg.max_points = 32768
    return system_mod.SLAMSystem(
        cfg, system_mod.Sensor.MONOCULAR, vocabulary=voc,
        enable_loop_closing=voc is not None,
    )


def main():
    data = bench_mod.get_sequence()
    voc = bench_mod.get_vocabulary(data, config_mod, system_mod)
    slam = make_mono_system(voc)
    frames_dev = [jnp.asarray(g, jnp.float32) for g, _ in data["frames"]]
    jax.block_until_ready(frames_dev)

    def one_pass():
        for i in range(N_FRAMES):
            slam.track_monocular(frames_dev[i], 1000.0 + i / 30.0)
        slam.tracker.flush()
        slam.flush_gba()

    one_pass()  # warmup compiles every program
    slam.reset()
    n_reps = int(os.environ.get("BENCH_REPS", "3"))
    fps_all = []
    for rep in range(n_reps):
        if rep:
            slam.reset()
        t0 = time.perf_counter()
        one_pass()
        el = time.perf_counter() - t0
        fps_all.append(N_FRAMES / el)
        print(f"[mono] pass {rep+1}/{n_reps}: {fps_all[-1]:.1f} fps "
              f"({el:.2f}s)", file=sys.stderr, flush=True)

    traj = slam.tracker.trajectory
    n_lost = sum(1 for (_, _, lost) in traj if lost)
    valid = np.asarray(slam.map.kf_valid)
    kf_ate = float("nan")
    if valid.sum() >= 3:
        ts = np.asarray(slam.map.kf_timestamp, np.float64)[valid] + (
            slam.tracker.ts_epoch or 0.0)
        est = np.linalg.inv(np.asarray(slam.map.kf_pose)[valid])
        gt_ts = 1000.0 + np.arange(N_FRAMES) / 30.0
        # Sim3 alignment: monocular scale is unobservable
        kf_ate = traj_io.ate_rmse(gt_ts, data["poses"], ts, est,
                                  with_scale=True)
    stats = {
        "metric": "mono_slam_fps_per_chip_loopclosing",
        "fps_median": round(float(np.median(fps_all)), 2),
        "fps_min": round(min(fps_all), 2),
        "fps_max": round(max(fps_all), 2),
        "reps": n_reps,
        "frames": N_FRAMES,
        "lost": n_lost,
        "keyframes": int(valid.sum()),
        "points": int(np.asarray(slam.map.pt_valid).sum()),
        "loops": len(slam.loop_closer.events) if slam.loop_closer else 0,
        "kf_ate_sim3_m": round(float(kf_ate), 4),
    }
    print(json.dumps(stats), flush=True)
    out = Path(__file__).resolve().parents[1] / "docs" / "BENCH_MONO.json"
    out.write_text(json.dumps(stats, indent=1))


if __name__ == "__main__":
    main()
