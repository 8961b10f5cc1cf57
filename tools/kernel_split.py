"""Attribute step time to individual tracking kernels and extraction stages."""
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
    print(f"{label:40s} {dt:8.2f} ms")
    return dt


def main():
    data = bench_mod.get_sequence()
    W, H = bench_mod.W, bench_mod.H
    cfg = config_mod.SystemConfig()
    cfg.camera = config_mod.CameraConfig(
        fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, width=W, height=H,
        bf=520.0 * 0.08, th_depth=50.0, fps=30,
    )
    cfg.orb = config_mod.ORBConfig(n_features=2000, n_levels=4,
                                   scale_factor=1.5)
    cfg.max_keypoints = 2048
    cfg.max_keyframes = 64
    cfg.max_points = 16384
    slam = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD,
                                 enable_loop_closing=False)
    frames_dev = [(jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
                  for g, d in data["frames"]]
    jax.block_until_ready(frames_dev)
    for i in range(12):
        g, d = frames_dev[i]
        slam.track_rgbd(g, d, 1000.0 + i / 30.0)
    slam.tracker.flush()

    trk = slam.tracker
    state = trk.map
    ctrl = trk.ctrl
    fr = slam.builder.build(frames_dev[12][0], 1000.4, frames_dev[12][1])
    jax.block_until_ready(fr)
    from orbslam_mapsave_tpu.pipeline import tracking as trk_mod
    kernels = trk_mod.make_tracking_kernels(
        slam.cam, slam.builder, cfg.orb.n_levels, cfg.orb.scale_factor)

    pose_pred = ctrl.velocity @ ctrl.pose
    th = jnp.asarray(15.0, jnp.float32)

    no_temp = jnp.asarray(False)
    m, pw, have, nm = kernels["track_motion"](
        state, fr, pose_pred, ctrl.last_matched, ctrl.last_frame, th,
        ctrl.pose, no_temp)
    t("track_motion", lambda: kernels["track_motion"](
        state, fr, pose_pred, ctrl.last_matched, ctrl.last_frame, th,
        ctrl.pose, no_temp))
    t("optimize_pose", lambda: kernels["optimize_pose"](state, fr, pose_pred, m))
    pose, mm, ninl = kernels["optimize_pose"](state, fr, pose_pred, m)
    t("gather_local_map", lambda: kernels["gather_local_map"](state, mm, pose))
    local_idx, ref2 = kernels["gather_local_map"](state, mm, pose)
    t("track_local_map", lambda: kernels["track_local_map"](
        state, fr, pose, mm, local_idx, jnp.asarray(3.0, jnp.float32)))
    t("track_ref_kf", lambda: kernels["track_ref_kf"](state, fr, ctrl.ref_kf))

    print("--- extraction stages ---")
    from orbslam_mapsave_tpu.ops import orb
    spec = slam.spec
    img = frames_dev[12][0]

    pyr = jax.jit(lambda im: orb.build_pyramid(spec, im))
    t("build_pyramid", lambda: pyr(img))
    pyramid = pyr(img)

    for lvl in [0]:
        ls = spec.levels[lvl]
        pad = pyramid[lvl]
        det = jax.jit(lambda p: orb.detect_level(spec, ls, p))
        t(f"detect_level L{lvl}", lambda: det(pad))
        xy, score = det(pad)
        sel = jax.jit(lambda s: jax.lax.top_k(s, ls.budget))
        t(f"top_k budget L{lvl}", lambda: sel(score))
        _, si = sel(score)
        xys = xy[si]
        ang = jax.jit(lambda p, x: orb.ic_angles(p, x))
        t(f"ic_angles L{lvl}", lambda: ang(pad, xys))
        a = ang(pad, xys)
        blur = jax.jit(orb.gaussian_blur7)
        t(f"gaussian_blur7 L{lvl}", lambda: blur(pad))
        bl = blur(pad)
        des = jax.jit(orb.brief_descriptors)
        t(f"brief_descriptors L{lvl}", lambda: des(bl, xys, a))

    bld = slam.builder
    t("builder.build (full)", lambda: bld.build(img, 1000.4, frames_dev[12][1]))
    t("fused step (full)", lambda: trk.step(state, ctrl, fr))


if __name__ == "__main__":
    main()
