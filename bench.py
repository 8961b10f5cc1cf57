"""Headline benchmark: tracked frames/s per device on a mapping-heavy
synthetic RGB-D loop at the reference's operating point (640x480, 2000 ORB
features, 4 pyramid levels — `Examples/ORB_RGBD640x480.yaml:58-64`).

Workload: a full circle revolution that produces a keyframe every ~6-8
frames (mapping + local BA run constantly inside the fused per-frame
program), with LOOP CLOSING ENABLED on a vocabulary trained from the
sequence itself — the timed region includes the loop event's Sim3 + fusion
+ essential graph + global BA.

Prints the device (platform, device_kind, count, and the card's name and
power limit) on stderr, then ONE JSON line: {"metric", "value", "unit",
"vs_baseline", ...}. `vs_baseline` is vs the reference's real-time design
target of 30 fps on a desktop CPU (README.md:31, `Camera.fps`, BASELINE.md —
the repo publishes no measured numbers; 30 fps input rate is its design
envelope). Refuses to run without a GPU unless JAX_PLATFORMS=cpu is set.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REFERENCE_FPS = 30.0
N_FRAMES = 240
W, H = 640, 480
CACHE = Path(__file__).parent / ".bench_cache"


def describe_device(allow_cpu: bool = False) -> dict:
    """Print the device JAX runs on (stderr) and return it as a dict.

    Without a GPU the run stops (exit 2): a number from another backend is
    not a device number. `allow_cpu` lets it go on when the user asked for
    the CPU explicitly with JAX_PLATFORMS=cpu."""
    import jax

    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    print(f"[device] jax {jax.__version__} platform={info['platform']} "
          f"kind={info['kind']} count={info['count']}", file=sys.stderr)
    if info["platform"] != "gpu":
        if allow_cpu and os.environ.get("JAX_PLATFORMS") == "cpu":
            return info
        print(f"[device] no GPU found (JAX reports {info['platform']}); set "
              "JAX_PLATFORMS=cpu to run on the CPU on purpose",
              file=sys.stderr)
        raise SystemExit(2)
    info["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"[device] {info['nvidia_smi']}", file=sys.stderr)
    return info


def get_sequence():
    """Render (and cache) the benchmark loop sequence."""
    import pickle

    CACHE.mkdir(exist_ok=True)
    f = CACHE / f"loop_{W}x{H}_{N_FRAMES}_v4.pkl"
    if f.exists():
        with open(f, "rb") as fh:
            return pickle.load(fh)
    from orbslam_mapsave_tpu.io import synthetic

    K = np.array([[520.0, 0, W / 2], [0, 520.0, H / 2], [0, 0, 1.0]])
    poses = synthetic.circle_trajectory(N_FRAMES, radius=0.55, revs=1.30)
    room = synthetic.BoxRoom(half_size=2.0, seed=11)
    frames = []
    for i in range(N_FRAMES):
        gray, depth = room.render(K, poses[i], W, H)
        # storage dtypes = what a sensor delivers (u8 image, f16 depth);
        # the frame builder converts on device
        frames.append((np.clip(gray, 0, 255).astype(np.uint8),
                       depth.astype(np.float16)))
    data = {"K": K, "poses": poses, "frames": frames}
    with open(f, "wb") as fh:
        pickle.dump(data, fh)
    return data


def make_system(voc, cfg_mod, system_mod):
    cfg = cfg_mod.SystemConfig()
    cfg.camera = cfg_mod.CameraConfig(
        fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, width=W, height=H,
        bf=520.0 * 0.08, th_depth=50.0, fps=30,
    )
    cfg.orb = cfg_mod.ORBConfig(n_features=2000, n_levels=4,
                                scale_factor=1.5)
    cfg.max_keypoints = 2048
    cfg.max_keyframes = 64
    cfg.max_points = 32768
    return system_mod.SLAMSystem(
        cfg, system_mod.Sensor.RGBD, vocabulary=voc,
        enable_loop_closing=voc is not None,
    )


def get_vocabulary(data, cfg_mod, system_mod):
    """Train (and cache) a vocabulary from the sequence's own frames."""
    from orbslam_mapsave_tpu.vocab import vocabulary

    f = CACHE / f"voc_{W}x{H}_{N_FRAMES}_v4.bin"
    if f.exists():
        return vocabulary.load_binary(f)
    sys_ = make_system(None, cfg_mod, system_mod)
    import jax.numpy as jnp

    descs = []
    for i in range(0, N_FRAMES, 12):
        g, d = data["frames"][i]
        fr = sys_.builder.build(jnp.asarray(g, jnp.float32),
                                1000.0 + i / 30.0,
                                jnp.asarray(d, jnp.float32))
        descs.append(np.asarray(fr.desc)[np.asarray(fr.valid)])
    voc = vocabulary.train(np.concatenate(descs), k=10, L=4, seed=1)
    vocabulary.save_binary(f, voc)
    return voc


def stage_frames(data):
    """Pre-stage the dataset on device (the dataset-benchmark operating
    mode: decode/transfer off the timed path, like the reference's
    LoadImages examples which pre-read the whole sequence from disk)."""
    import jax
    import jax.numpy as jnp

    frames_dev = [
        (jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
        for g, d in data["frames"]
    ]
    jax.block_until_ready(frames_dev)
    return frames_dev


def run_pass(slam, frames_dev) -> tuple[float, np.ndarray]:
    """One pass over the sequence, drained to the host; returns
    (wall seconds, per-frame host ms)."""
    frame_ms = np.empty(len(frames_dev))
    t0 = time.perf_counter()
    tprev = t0
    for i, (g, d) in enumerate(frames_dev):
        slam.track_rgbd(g, d, 1000.0 + i / 30.0)
        tnow = time.perf_counter()
        frame_ms[i] = 1e3 * (tnow - tprev)
        tprev = tnow
    slam.tracker.flush()
    slam.flush_gba()
    return time.perf_counter() - t0, frame_ms


def trajectory_quality(slam, data) -> dict:
    """Lost frames, loop events and keyframe ATE (m) against the exact
    ground truth of the rendered sequence."""
    from orbslam_mapsave_tpu.io import trajectory as traj_io

    traj = slam.tracker.trajectory
    valid = np.asarray(slam.map.kf_valid)
    kf_ate = float("nan")
    if valid.any():
        ts = np.asarray(slam.map.kf_timestamp, np.float64)[valid] + (
            slam.tracker.ts_epoch or 0.0)
        est = np.linalg.inv(np.asarray(slam.map.kf_pose)[valid])
        gt_ts = 1000.0 + np.arange(N_FRAMES) / 30.0
        kf_ate = traj_io.ate_rmse(gt_ts, data["poses"], ts, est)
    return {
        "lost": sum(1 for (_, _, lost) in traj if lost),
        "loops": len(slam.loop_closer.events) if slam.loop_closer else 0,
        "kf_ate": kf_ate,
        "kfs": slam.n_keyframes,
        "pts": slam.n_points,
    }


def main():
    device = describe_device(allow_cpu=True)
    data = get_sequence()

    from orbslam_mapsave_tpu import config as config_mod
    from orbslam_mapsave_tpu.pipeline import system as system_mod

    voc = None if os.environ.get("BENCH_NO_LOOP") else get_vocabulary(
        data, config_mod, system_mod)
    slam = make_system(voc, config_mod, system_mod)
    frames_dev = stage_frames(data)

    # warmup: one FULL untimed pass over the workload on the SAME system,
    # then reset() (which keeps the jitted programs and only clears state)
    # — compiles every program the timed run will touch (tracking, mapping
    # keyframe steps, loop detection, Sim3, correction, pose graph, GBA).
    # A throwaway warm system is NOT equivalent: the jitted step closures
    # are per-instance, so a fresh timed system would re-trace and, on an
    # in-process cache miss, re-COMPILE inside the timed region. The
    # reference pays its startup (vocabulary load, lazy allocation)
    # outside its per-frame timings; XLA compilation is this framework's
    # startup cost and the persistent cache amortizes it across processes.
    run_pass(slam, frames_dev)
    slam.reset()

    # R timed passes, MEDIAN is the headline. Per-pass frame stats make a
    # stall visible and attributable: a host hiccup shows up as a huge
    # max-frame ms in exactly one pass while the median stays
    # representative of compute.
    n_reps = int(os.environ.get("BENCH_REPS", "5"))
    pass_stats = []
    for rep in range(n_reps):
        if rep:
            slam.reset()
        elapsed, frame_ms = run_pass(slam, frames_dev)
        pass_stats.append({
            "fps": N_FRAMES / elapsed,
            "wall_s": elapsed,
            "p50_ms": float(np.percentile(frame_ms, 50)),
            "p99_ms": float(np.percentile(frame_ms, 99)),
            "max_ms": float(frame_ms.max()),
            "stalls": int((frame_ms > 500.0).sum()),
        })
        print(
            f"[bench] pass {rep + 1}/{n_reps}: {pass_stats[-1]['fps']:.1f} "
            f"fps wall={elapsed:.2f}s p50={pass_stats[-1]['p50_ms']:.2f} "
            f"p99={pass_stats[-1]['p99_ms']:.1f} "
            f"max={pass_stats[-1]['max_ms']:.0f}ms "
            f"stalls>500ms={pass_stats[-1]['stalls']}",
            file=sys.stderr,
        )
    all_fps = sorted(s["fps"] for s in pass_stats)
    fps = float(np.median(all_fps))

    q = trajectory_quality(slam, data)
    print(
        f"[bench] frames={N_FRAMES} reps={n_reps} "
        f"median={fps:.1f} min={all_fps[0]:.1f} max={all_fps[-1]:.1f} fps "
        f"avg_ms={1e3 / fps:.1f} lost={q['lost']} kfs={q['kfs']} "
        f"pts={q['pts']} loops={q['loops']} kf_ate={q['kf_ate']:.4f}m",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "rgbd_slam_fps_loopclosing",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / REFERENCE_FPS, 3),
        "fps_min": round(all_fps[0], 2),
        "fps_max": round(all_fps[-1], 2),
        "reps": n_reps,
        "device": device,
    }))


if __name__ == "__main__":
    main()
