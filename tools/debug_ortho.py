"""Test the SO(3)-drift hypothesis: measure ||R R^T - I|| of the chained
pose per frame, and run a second chain that re-orthonormalizes the pose
before the velocity update. If drift disappears, root cause confirmed."""
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import jax.numpy as jnp
import numpy as np

import bench as bench_mod
from orbslam_mapsave_tpu import config as config_mod
from orbslam_mapsave_tpu.geometry import se3
from orbslam_mapsave_tpu.pipeline import system as system_mod


def orthonormalize(T):
    T = np.asarray(T, np.float64)
    U, _, Vt = np.linalg.svd(T[:3, :3])
    R = U @ Vt
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R
    out[:3, 3] = T[:3, 3]
    return jnp.asarray(out)


def pose_err(Tcw_est, Tcw_gt):
    d = np.asarray(Tcw_est, np.float64) @ np.linalg.inv(np.asarray(Tcw_gt))
    t = np.linalg.norm(d[:3, 3])
    # proper rotation error: orthonormalize d first
    U, _, Vt = np.linalg.svd(d[:3, :3])
    Rn = U @ Vt
    ang = np.degrees(np.arccos(np.clip((np.trace(Rn) - 1) / 2, -1, 1)))
    northo = np.linalg.norm(d[:3, :3] @ d[:3, :3].T - np.eye(3))
    return t, ang, northo


def main():
    W, H = bench_mod.W, bench_mod.H
    data = bench_mod.get_sequence()
    gt_Twc = data["poses"]
    gt_Tcw = [np.linalg.inv(T) for T in gt_Twc]

    cfg = config_mod.SystemConfig()
    cfg.camera = config_mod.CameraConfig(fx=520.0, fy=520.0, cx=W / 2,
                                         cy=H / 2, width=W, height=H,
                                         fps=30, bf=40.0, th_depth=40.0)
    sysm = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD,
                                 enable_loop_closing=False)
    trk = sysm.tracker
    k = trk.k
    tcfg = trk.cfg

    st = sysm.map
    frames = [sysm.builder.build(g, i / 30.0, d)
              for i, (g, d) in enumerate(data["frames"][:24])]
    st, kf, matched0, _ = k["init_rgbd"](st, frames[0],
                                         jnp.asarray(0, jnp.int32))

    def run_track(fr, pose_pred, last_matched, last_frame):
        m, nm = k["track_motion"](st, fr, pose_pred, last_matched, last_frame,
                                  jnp.asarray(tcfg.motion_th, jnp.float32))
        pose1, m1, _ = k["optimize_pose"](st, fr, pose_pred, m)
        local_idx, ref2 = k["gather_local_map"](st, m1, pose1)
        st2, pose2, m2, n_inl = k["track_local_map"](
            st, fr, pose1, m1, local_idx,
            jnp.asarray(tcfg.local_th, jnp.float32))
        return pose2, m2, int(n_inl)

    def chain(orth: bool):
        pose, vel, has_vel = jnp.eye(4), jnp.eye(4), False
        last_m, last_f = matched0, frames[0]
        rows = []
        for i in range(1, 24):
            gt_rel = gt_Tcw[i] @ gt_Twc[0]
            pred = vel @ pose if has_vel else pose
            p2, m2, ninl = run_track(frames[i], pred, last_m, last_f)
            if orth:
                p2 = orthonormalize(p2)
            te, ae, no = pose_err(p2, gt_rel)
            rows.append((te, ae, no, ninl))
            vel = p2 @ se3.se3_inv(pose)
            pose = p2
            has_vel = True
            last_m, last_f = m2, frames[i]
        return rows

    raw = chain(False)
    fixed = chain(True)
    print(" f |   raw: t_err ang(proper) ||RRt-I||  inl |   orthofix: t_err ang inl")
    for i, (r, x) in enumerate(zip(raw, fixed), start=1):
        print(f"f{i:02d} | {r[0]*1000:7.1f}mm {r[1]:6.2f}d {r[2]:9.2e} {r[3]:4d}"
              f" | {x[0]*1000:7.1f}mm {x[1]:6.2f}d {x[3]:4d}")


if __name__ == "__main__":
    main()
