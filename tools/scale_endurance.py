"""Reference-scale endurance: >=1024 live keyframes / ~200k points on the
real chip, with culling + compaction + loop closing active (VERDICT r4
missing #1 — the reference holds KITTI-00-class maps, `src/Map.cc:150`).

Workload: a toroidal sweep inside a large BoxRoom — many revolutions at
varying radius/height, so every revolution sees the walls from a new
vantage (keyframes keep firing) while revisits across revolutions give
loop closures. 320x240 / 1000 features keeps the render and extract cost
proportionate; the SCALE axis under test is the map: K_cap=1536 keyframes,
P_cap=262144 points, which routes GBA to the no-one-hot dual-layout PCG
(optim/global_ba._solve_pcg_dual — the (P,O,K) one-hot would be ~26 GB)
and the essential graph to the matrix-free CG solver.

Two passes over the sequence: pass 1 warms every program shape (compile),
pass 2 is timed. Writes docs/SCALE.json.
"""
import json
import os
import pickle
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

if os.environ.get("SCALE_CPU"):  # smoke-test the tool off-chip
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from orbslam_mapsave_tpu import config as config_mod
from orbslam_mapsave_tpu.io import synthetic
from orbslam_mapsave_tpu.io import trajectory as traj_io
from orbslam_mapsave_tpu.pipeline import system as system_mod
from orbslam_mapsave_tpu.vocab import vocabulary

W, H = 320, 240
FX = 260.0
N_FRAMES = int(os.environ.get("SCALE_FRAMES", "8000"))
REVS = 16
CACHE = Path(__file__).resolve().parents[1] / ".bench_cache"


def sweep_trajectory(n):
    """Volume-filling Lissajous wander with an independent slow yaw sweep:
    position novelty (the camera approaches every wall from many offsets
    and distances) drives continuous keyframe creation, while the periodic
    yaw alignment re-observes earlier vantages for loop closures. The
    first toroidal design re-viewed the same wall bands and produced only
    ~1 keyframe per 50 frames — far below the reference-scale target."""
    poses = np.zeros((n, 4, 4))
    for i in range(n):
        u = i / n
        x = 1.55 * np.sin(2 * np.pi * 3.0 * u + 0.7)
        y = 1.15 * np.sin(2 * np.pi * 5.0 * u + 1.9)
        z = 1.55 * np.sin(2 * np.pi * 4.0 * u + 0.2)
        # ~1 deg/frame yaw: keyframe creation tracks view-direction
        # turnover (9 revs gave 1 KF per ~50 frames; 44 revs lost
        # tracking), paired with a tighter ThDepth for coverage pressure
        yaw = 2 * np.pi * 22.0 * u
        pitch = 0.18 * np.sin(2 * np.pi * 9.0 * u)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        T = np.eye(4)
        T[:3, :3] = Ry @ Rx
        T[:3, 3] = [x, y, z]
        poses[i] = T
    return poses


def get_sequence():
    CACHE.mkdir(exist_ok=True)
    f = CACHE / f"scale_{W}x{H}_{N_FRAMES}_v4.pkl"
    if f.exists():
        with open(f, "rb") as fh:
            return pickle.load(fh)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    poses = sweep_trajectory(N_FRAMES)
    room = synthetic.BoxRoom(half_size=2.5, seed=3)
    frames = []
    t0 = time.perf_counter()
    for i in range(N_FRAMES):
        g, d = room.render(K, poses[i], W, H)
        frames.append((np.clip(g, 0, 255).astype(np.uint8),
                       d.astype(np.float16)))
        if i % 1000 == 999:
            print(f"render {i + 1}/{N_FRAMES} ({time.perf_counter()-t0:.0f}s)",
                  flush=True)
    data = {"K": K, "poses": poses, "frames": frames}
    with open(f, "wb") as fh:
        pickle.dump(data, fh)
    return data


def make_system(voc):
    cfg = config_mod.SystemConfig()
    cfg.camera = config_mod.CameraConfig(
        fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H,
        # ThDepth 30 (2.4 m at bf=0.08*fx): beyond-2.4 m features do not
        # count as close, so mid-room vantages keep ratioMap low and the
        # keyframe policy (Tracking.cc:1277-1295 analogue) under pressure
        bf=FX * 0.08, th_depth=30.0, fps=30,
    )
    cfg.orb = config_mod.ORBConfig(n_features=1000, n_levels=4,
                                   scale_factor=1.5)
    cfg.max_keypoints = 1024
    cfg.max_keyframes = 1536
    cfg.max_points = 262144
    return system_mod.SLAMSystem(
        cfg, system_mod.Sensor.RGBD, vocabulary=voc,
        enable_loop_closing=voc is not None,
    )


def get_vocabulary(data):
    f = CACHE / f"scale_voc_{W}x{H}_v1.bin"
    if f.exists():
        return vocabulary.load_binary(f)
    sys_ = make_system(None)
    descs = []
    for i in range(0, N_FRAMES, 60):
        g, d = data["frames"][i]
        fr = sys_.builder.build(jnp.asarray(g, jnp.float32),
                                1000.0 + i / 30.0,
                                jnp.asarray(d, jnp.float32))
        descs.append(np.asarray(fr.desc)[np.asarray(fr.valid)])
    voc = vocabulary.train(np.concatenate(descs), k=10, L=4, seed=1)
    vocabulary.save_binary(f, voc)
    return voc


def run_pass(slam, frames_dev, timed):
    t_frame = np.zeros(N_FRAMES)
    t0_all = time.perf_counter()
    for i in range(N_FRAMES):
        g, d = frames_dev[i]
        t0 = time.perf_counter()
        slam.track_rgbd(g.astype(jnp.float32), d.astype(jnp.float32),
                        1000.0 + i / 30.0)
        t_frame[i] = time.perf_counter() - t0
        if i % 1000 == 999:
            print(f"  frame {i}: cum {time.perf_counter()-t0_all:.1f}s "
                  f"kfs={slam.tracker.n_kf_watermark} "
                  f"loops={len(slam.loop_closer.events)}", flush=True)
    slam.tracker.flush()
    slam.flush_gba()
    return time.perf_counter() - t0_all, t_frame


def main():
    data = get_sequence()
    voc = get_vocabulary(data)
    slam = make_system(voc)
    # stage in sensor dtypes (u8/f16, half the HBM of f32); cast at call
    frames_dev = [(jnp.asarray(g), jnp.asarray(d))
                  for g, d in data["frames"]]
    jax.block_until_ready(frames_dev)

    compactions = [0]
    orig_compact = slam._maybe_compact

    def counted_compact():
        before = (slam.tracker.n_pt_watermark, slam.tracker.n_kf_watermark)
        orig_compact()
        if (slam.tracker.n_pt_watermark,
                slam.tracker.n_kf_watermark) != before \
                and slam.tracker.n_pt_watermark == 0:
            compactions[0] += 1
    slam._maybe_compact = counted_compact

    if not os.environ.get("SCALE_NO_WARMUP"):
        print("warmup pass (compiles at scale shapes)...", flush=True)
        tw, _ = run_pass(slam, frames_dev, timed=False)
        print(f"warmup pass: {tw:.1f}s", flush=True)
        slam.reset()
        compactions[0] = 0

    print("timed pass...", flush=True)
    total, t_frame = run_pass(slam, frames_dev, timed=True)

    valid = np.asarray(slam.map.kf_valid)
    ts = np.asarray(slam.map.kf_timestamp, np.float64)[valid] + (
        slam.tracker.ts_epoch or 0.0)
    est = np.linalg.inv(np.asarray(slam.map.kf_pose)[valid])
    gt_ts = 1000.0 + np.arange(N_FRAMES) / 30.0
    kf_ate = traj_io.ate_rmse(gt_ts, data["poses"], ts, est)

    stats = {
        "frames": N_FRAMES,
        "total_s": round(total, 2),
        "fps": round(N_FRAMES / total, 2),
        "p50_ms": round(float(np.percentile(t_frame, 50)) * 1e3, 2),
        "p90_ms": round(float(np.percentile(t_frame, 90)) * 1e3, 2),
        "p99_ms": round(float(np.percentile(t_frame, 99)) * 1e3, 2),
        "max_ms": round(float(t_frame.max()) * 1e3, 2),
        "n_stalls_over_1s": int((t_frame > 1.0).sum()),
        "keyframes_live": int(valid.sum()),
        "kf_alloc_watermark": int(slam.tracker.n_kf_watermark),
        "points_live": int(np.asarray(slam.map.pt_valid).sum()),
        "loops": len(slam.loop_closer.events),
        "compactions": compactions[0],
        "kf_ate_m": round(float(kf_ate), 4),
        "ba_lanes_dropped": slam.tracker.ba_lanes_dropped,
        "ba_escalations": slam.tracker.ba_escalations,
        "gba_solver": "pcg_dual (no one-hot)",
        "pose_graph_solver": "cg (matrix-free)",
        "caps": {"K": 1536, "P": 262144, "N": 1024},
    }
    print(json.dumps(stats), flush=True)
    out = Path(__file__).resolve().parents[1] / "docs" / "SCALE.json"
    out.write_text(json.dumps(stats, indent=1))


if __name__ == "__main__":
    main()
