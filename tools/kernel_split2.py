"""Tracking-kernel split at LATE-map scale (the bench's slow regime):
drives 200 frames of the bench loop first, then times extraction, the full
fused step, and each tracking kernel against the grown map."""
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
import jax.numpy as jnp

import bench as bench_mod
from orbslam_mapsave_tpu import config as config_mod
from orbslam_mapsave_tpu.pipeline import system as system_mod


def t(label, fn, n=20):
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n * 1000
    print(f"{label:40s} {dt:8.2f} ms", flush=True)
    return dt


def main():
    data = bench_mod.get_sequence()
    slam = bench_mod.make_system(None, config_mod, system_mod)
    frames_dev = [(jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
                  for g, d in data["frames"]]
    jax.block_until_ready(frames_dev)
    for i in range(200):
        g, d = frames_dev[i]
        slam.track_rgbd(g, d, 1000.0 + i / 30.0)
    slam.tracker.flush()
    print("kfs", slam.n_keyframes, "pts", slam.n_points, flush=True)

    trk = slam.tracker
    state = trk.map
    ctrl = trk.ctrl
    g, d = frames_dev[200]
    t("frame build (ORB extract)", lambda: slam.builder.build(g, 1006.6, d))
    fr = slam.builder.build(g, 1006.6, d)
    jax.block_until_ready(fr)
    t("FULL fused step", lambda: trk.step(state, ctrl, fr)[1].pose)

    from orbslam_mapsave_tpu.pipeline import tracking as trk_mod
    kernels = trk.k if hasattr(trk, "k") else trk_mod.make_tracking_kernels(
        slam.cam, slam.builder, slam.cfg.orb.n_levels,
        slam.cfg.orb.scale_factor)

    pose_pred = ctrl.velocity @ ctrl.pose
    th = jnp.asarray(15.0, jnp.float32)
    no_temp = jnp.asarray(False)
    m, pw, have, nm = kernels["track_motion"](
        state, fr, pose_pred, ctrl.last_matched, ctrl.last_frame, th,
        ctrl.pose, no_temp)
    t("track_motion", lambda: kernels["track_motion"](
        state, fr, pose_pred, ctrl.last_matched, ctrl.last_frame, th,
        ctrl.pose, no_temp))
    t("optimize_pose", lambda: kernels["optimize_pose"](
        state, fr, pose_pred, m))
    pose, mm, ninl = kernels["optimize_pose"](state, fr, pose_pred, m)
    t("gather_local_map", lambda: kernels["gather_local_map"](state, mm, pose))
    local_idx, ref2 = kernels["gather_local_map"](state, mm, pose)
    t("track_local_map", lambda: kernels["track_local_map"](
        state, fr, pose, mm, local_idx, jnp.asarray(3.0, jnp.float32)))
    t("track_ref_kf", lambda: kernels["track_ref_kf"](state, fr, ctrl.ref_kf))


if __name__ == "__main__":
    main()
