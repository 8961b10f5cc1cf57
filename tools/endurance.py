"""Long-sequence endurance run (VERDICT r2 item 5): 1200 frames, two+
revolutions (>= 2 loop closures), K_cap=256 / 64k points with slot
compaction firing inside the timed region. Records frame-time percentiles,
loop events, compactions and final keyframe ATE to docs/ENDURANCE.json.

Run on the GPU: python tools/endurance.py
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
import jax.numpy as jnp
import numpy as np

from orbslam_mapsave_tpu import config as config_mod
from orbslam_mapsave_tpu.io import synthetic, trajectory as traj_io
from orbslam_mapsave_tpu.pipeline import system as system_mod
from orbslam_mapsave_tpu.vocab import vocabulary

N_FRAMES = 1200
W, H = 640, 480
CACHE = Path(__file__).resolve().parents[1] / ".bench_cache"


def get_sequence():
    CACHE.mkdir(exist_ok=True)
    f = CACHE / f"endurance_{W}x{H}_{N_FRAMES}_v1.pkl"
    if f.exists():
        with open(f, "rb") as fh:
            return pickle.load(fh)
    K = np.array([[520.0, 0, W / 2], [0, 520.0, H / 2], [0, 0, 1.0]])
    poses = synthetic.circle_trajectory(N_FRAMES, radius=0.55, revs=2.6)
    room = synthetic.BoxRoom(half_size=2.0, seed=11)
    frames = []
    for i in range(N_FRAMES):
        gray, depth = room.render(K, poses[i], W, H)
        frames.append((np.clip(gray, 0, 255).astype(np.uint8),
                       depth.astype(np.float16)))
        if i % 200 == 0:
            print(f"render {i}/{N_FRAMES}", flush=True)
    data = {"K": K, "poses": poses, "frames": frames}
    with open(f, "wb") as fh:
        pickle.dump(data, fh, protocol=4)
    return data


def main():
    data = get_sequence()
    cfg = config_mod.SystemConfig()
    cfg.camera = config_mod.CameraConfig(
        fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, width=W, height=H,
        bf=520.0 * 0.08, th_depth=50.0, fps=30,
    )
    cfg.orb = config_mod.ORBConfig(n_features=2000, n_levels=4,
                                   scale_factor=1.5)
    cfg.max_keypoints = 2048
    cfg.max_keyframes = 256
    cfg.max_points = 49152  # sized so the allocator crosses the 0.9 compaction trigger in-region

    # vocabulary from the bench cache sequence (same renderer) or train one
    import bench as bench_mod

    voc_f = CACHE / f"voc_{W}x{H}_240_v4.bin"
    if voc_f.exists():
        voc = vocabulary.load_binary(voc_f)
    else:
        bdata = bench_mod.get_sequence()
        voc = bench_mod.get_vocabulary(bdata, config_mod, system_mod)

    slam = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD, vocabulary=voc)

    print("staging frames on device...", flush=True)
    frames_dev = [
        (jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
        for g, d in data["frames"]
    ]
    jax.block_until_ready(frames_dev)

    compactions = [0]
    orig_compact = slam._maybe_compact

    def counted_compact():
        before = (slam.tracker.n_pt_watermark, slam.tracker.n_kf_watermark)
        orig_compact()
        if (slam.tracker.n_pt_watermark, slam.tracker.n_kf_watermark) != \
                before and slam.tracker.n_pt_watermark == 0:
            compactions[0] += 1

    slam._maybe_compact = counted_compact

    # warmup: one full untimed pass compiles every program the timed run
    # touches (incl. the loop-event programs at the K=256 shapes), same
    # protocol as bench.py; reset() keeps the jitted closures
    if not os.environ.get("ENDURANCE_NO_WARMUP"):
        tw = time.perf_counter()
        for i in range(N_FRAMES):
            g, d = frames_dev[i]
            slam.track_rgbd(g, d, 1000.0 + i / 30.0)
            if i % 200 == 199:
                print(f"warmup {i}: cum {time.perf_counter()-tw:.1f}s",
                      flush=True)
        slam.tracker.flush()
        slam.flush_gba()
        slam.reset()
        print(f"warmup pass: {time.perf_counter()-tw:.1f}s", flush=True)

    t_frame = np.zeros(N_FRAMES)
    t0_all = time.perf_counter()
    for i in range(N_FRAMES):
        g, d = frames_dev[i]
        t0 = time.perf_counter()
        slam.track_rgbd(g, d, 1000.0 + i / 30.0)
        t_frame[i] = time.perf_counter() - t0
        if i % 200 == 199:
            print(f"frame {i}: cum {time.perf_counter()-t0_all:.1f}s "
                  f"loops={len(slam.loop_closer.events)}", flush=True)
    slam.tracker.flush()
    slam.flush_gba()
    total = time.perf_counter() - t0_all

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
        "loops": len(slam.loop_closer.events),
        "compactions": compactions[0],
        "keyframes": int(valid.sum()),
        "points": int(np.asarray(slam.map.pt_valid).sum()),
        "kf_ate_m": round(float(kf_ate), 4),
        # O_BA truncation telemetry (VERDICT r4 weak #3): lanes lost even
        # after O_BA_ESC escalation must stay 0
        "ba_lanes_dropped": slam.tracker.ba_lanes_dropped,
        "ba_escalations": slam.tracker.ba_escalations,
    }
    print(json.dumps(stats), flush=True)
    out = Path(__file__).resolve().parents[1] / "docs" / "ENDURANCE.json"
    out.write_text(json.dumps(stats, indent=1))


if __name__ == "__main__":
    main()
