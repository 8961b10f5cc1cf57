"""Stage-level tracking diagnosis: run the tracking kernels manually."""
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
from orbslam_mapsave_tpu.pipeline import system as system_mod, fused_step


def main():
    W, H = bench_mod.W, bench_mod.H
    data = bench_mod.get_sequence()
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
    ctrl = None
    for i, (g, d) in enumerate(data["frames"][:24]):
        fr = sysm.builder.build(g, i / 30.0, d)
        if ctrl is None:
            ctrl = fused_step.initial_control_state(fr.kp_xy.shape[0], fr)
        if i == 0:
            st, kf, matched, n_pts = k["init_rgbd"](st, fr,
                                                    jnp.asarray(0, jnp.int32))
            ctrl = ctrl._replace(
                mode=jnp.asarray(fused_step.MODE_OK, jnp.int32),
                ref_kf=kf, frame_id=jnp.asarray(1, jnp.int32),
                last_matched=matched, last_frame=fr,
            )
            print(f"f00 init pts={int(n_pts)}")
            continue
        pose_pred = ctrl.velocity @ ctrl.pose if bool(ctrl.has_velocity) else ctrl.pose
        m, nm = k["track_motion"](st, fr, pose_pred, ctrl.last_matched,
                                  ctrl.last_frame,
                                  jnp.asarray(tcfg.motion_th, jnp.float32))
        nm_i = int(nm)
        pose1, m1, ninl1 = k["optimize_pose"](st, fr, pose_pred, m)
        local_idx, ref2 = k["gather_local_map"](st, m1, pose1)
        n_local = int(jnp.sum(local_idx >= 0))
        st, pose2, m2, n_inl = k["track_local_map"](
            st, fr, pose1, m1, local_idx, jnp.asarray(tcfg.local_th, jnp.float32))
        n_after_motion = int(ninl1)
        print(f"f{i:02d} motion_matches={nm_i:4d} motion_inl={n_after_motion:4d} "
              f"local_set={n_local:5d} final_inl={int(n_inl):4d} ref={int(ref2)}")
        # update ctrl like _track_ok (no KF creation in this debug loop)
        from orbslam_mapsave_tpu.geometry import se3
        ok2 = int(n_inl) >= 30
        vel = pose2 @ se3.se3_inv(ctrl.pose)
        ctrl = ctrl._replace(
            pose=pose2 if ok2 else ctrl.pose,
            velocity=vel if ok2 else jnp.eye(4),
            has_velocity=jnp.asarray(ok2),
            ref_kf=ref2,
            frame_id=ctrl.frame_id + 1,
            last_matched=m2,
            last_frame=fr,
        )


if __name__ == "__main__":
    main()
