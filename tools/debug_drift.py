"""Quantify tracking drift vs ground truth on the bench sequence.

Two modes per frame, frozen map (init from f0 only):
  chain : pose_pred = velocity-chained previous estimate (normal tracking)
  gt    : pose_pred = ground-truth Tcw (perfect prediction)
If `gt` mode still lands away from GT after optimize_pose+track_local_map,
the per-frame matcher/optimizer is biased; if only `chain` drifts, the bias
accumulates through the motion model.
"""
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
import jax.numpy as jnp
import numpy as np

import bench as bench_mod
from orbslam_mapsave_tpu import config as config_mod
from orbslam_mapsave_tpu.geometry import se3
from orbslam_mapsave_tpu.pipeline import system as system_mod, fused_step


def pose_err(Tcw_est, Tcw_gt):
    d = np.asarray(Tcw_est) @ np.linalg.inv(np.asarray(Tcw_gt))
    t = np.linalg.norm(d[:3, 3])
    ang = np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))
    return t, ang


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
    frames = []
    for i, (g, d) in enumerate(data["frames"][:24]):
        frames.append(sysm.builder.build(g, i / 30.0, d))

    ctrl = fused_step.initial_control_state(frames[0].kp_xy.shape[0], frames[0])
    st, kf, matched, n_pts = k["init_rgbd"](st, frames[0],
                                            jnp.asarray(0, jnp.int32))
    print(f"f00 init pts={int(n_pts)}  (init pose assumed = GT f0? "
          f"gt_Tcw[0] t={np.linalg.norm(gt_Tcw[0][:3,3]):.4f})")

    def run_track(st, fr, pose_pred, last_matched, last_frame):
        m, nm = k["track_motion"](st, fr, pose_pred, last_matched, last_frame,
                                  jnp.asarray(tcfg.motion_th, jnp.float32))
        pose1, m1, ninl1 = k["optimize_pose"](st, fr, pose_pred, m)
        local_idx, ref2 = k["gather_local_map"](st, m1, pose1)
        st2, pose2, m2, n_inl = k["track_local_map"](
            st, fr, pose1, m1, local_idx,
            jnp.asarray(tcfg.local_th, jnp.float32))
        return pose1, pose2, m2, int(nm), int(ninl1), int(n_inl)

    # note: frame-0 pose in the map is whatever init_rgbd used; GT f0 is not
    # identity, so compare in the init frame: Terr = est @ inv(gt_rel)
    # where gt_rel = gt_Tcw[i] @ inv(gt_Tcw[0])
    pose_chain = jnp.eye(4)
    vel = jnp.eye(4)
    has_vel = False
    last_m, last_f = matched, frames[0]
    last_m_gt, last_f_gt = matched, frames[0]
    print(" f | chain: t_err  ang | inl(mot/loc) || gtpred: t_err  ang | inl")
    for i in range(1, 24):
        fr = frames[i]
        gt_rel = gt_Tcw[i] @ gt_Twc[0]  # Tcw in init(=f0 camera) frame
        # --- chained
        pose_pred = vel @ pose_chain if has_vel else pose_chain
        p1, p2, m2, nm, ninl1, ninl2 = run_track(st, fr, pose_pred,
                                                 last_m, last_f)
        te, ae = pose_err(p2, gt_rel)
        # --- gt-seeded (independent of chain; uses same frozen map)
        gp1, gp2, gm2, gnm, gninl1, gninl2 = run_track(
            st, fr, jnp.asarray(gt_rel), last_m_gt, last_f_gt)
        gte, gae = pose_err(gp2, gt_rel)
        gte1, gae1 = pose_err(gp1, gt_rel)
        print(f"f{i:02d} | {te*1000:7.1f}mm {ae:5.2f}d | {ninl1:4d}/{ninl2:4d}"
              f" || {gte*1000:7.1f}mm {gae:5.2f}d"
              f" (p1 {gte1*1000:6.1f}mm {gae1:4.2f}d) | {gninl1:4d}/{gninl2:4d}")
        vel = p2 @ se3.se3_inv(pose_chain)
        pose_chain = p2
        has_vel = True
        last_m, last_f = m2, fr
        last_m_gt, last_f_gt = gm2, fr


if __name__ == "__main__":
    main()
