"""Basin-test pose opt on the PRE-strip merged match set at frame 15."""
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
from orbslam_mapsave_tpu.ops import matching
from orbslam_mapsave_tpu.optim import pose_opt
from orbslam_mapsave_tpu.pipeline import system as system_mod, fused_step


def main():
    W, H = bench_mod.W, bench_mod.H
    data = bench_mod.get_sequence()
    poses = np.asarray(data["poses"])
    cfg = config_mod.SystemConfig()
    cfg.camera = config_mod.CameraConfig(fx=520.0, fy=520.0, cx=W / 2,
                                         cy=H / 2, width=W, height=H,
                                         fps=30, bf=40.0, th_depth=40.0)
    sysm = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD,
                                 enable_loop_closing=False)
    trk = sysm.tracker
    k = trk.k
    st = sysm.map
    ctrl = None
    gt_rel = [np.linalg.inv(poses[0]) @ poses[i] for i in range(40)]
    F = 15
    for i, (g, d) in enumerate(data["frames"][: F + 1]):
        fr = sysm.builder.build(g, i / 30.0, d)
        if ctrl is None:
            ctrl = fused_step.initial_control_state(fr.kp_xy.shape[0], fr)
        if i == 0:
            st, kf, matched, _ = k["init_rgbd"](st, fr,
                                                jnp.asarray(0, jnp.int32))
            ctrl = ctrl._replace(mode=jnp.asarray(2, jnp.int32), ref_kf=kf,
                                 last_matched=matched, last_frame=fr)
            continue
        if i == F:
            break
        st, ctrl, out = trk.step(st, ctrl, fr)

    # reproduce frame F's tracking manually up to the pre-strip merge
    pose_pred = ctrl.velocity @ ctrl.pose
    m, nm = k["track_motion"](st, fr, pose_pred, ctrl.last_matched,
                              ctrl.last_frame, jnp.asarray(15.0, jnp.float32))
    pose1, m1, ninl1 = k["optimize_pose"](st, fr, pose_pred, m)
    local_idx, _ = k["gather_local_map"](st, m1, pose1)
    # replicate track_local_map WITHOUT the final strip
    lp = jnp.clip(local_idx, 0)
    lp_valid = (local_idx >= 0) & st.pt_valid[lp]
    already = jnp.zeros(st.pt_capacity, bool).at[jnp.clip(m1, 0)].set(m1 >= 0)
    lp_valid = lp_valid & ~already[lp]
    from orbslam_mapsave_tpu.ops import hamming
    new_matches, n_new, visible = matching.search_by_projection_points(
        sysm.cam, pose1, fr.kp_xy, fr.kp_octave, fr.desc_bits, fr.valid,
        m1 >= 0, st.pt_pos[lp], st.pt_normal[lp], st.pt_min_dist[lp],
        st.pt_max_dist[lp], hamming.unpack_bits(st.pt_desc[lp]),
        lp_valid, sysm.builder.bounds, sysm.builder.scale_factors, th=3.0,
        n_levels=4, scale_factor=1.5,
    )
    merged = jnp.where((new_matches >= 0) & (m1 < 0),
                       local_idx[jnp.clip(new_matches, 0)], m1)
    gt_t = gt_rel[F][:3, 3]
    Tgt = np.linalg.inv(gt_rel[F]).astype(np.float32)

    def basin(mm, tag):
        for T0, itag in ((Tgt, "GT"), (np.asarray(pose_pred), "pred")):
            p, _, ninl = k["optimize_pose"](st, fr, jnp.asarray(T0), mm)
            terr = np.linalg.norm(np.linalg.inv(np.asarray(p))[:3, 3] - gt_t)
            print(f"{tag:24s} init={itag:5s} -> terr={terr*1000:7.2f} mm "
                  f"inl={int(ninl)}")

    # how wrong is the prediction?
    perr = np.linalg.norm(np.linalg.inv(np.asarray(pose_pred))[:3, 3] - gt_t)
    print(f"prediction terr = {perr*1000:.2f} mm; motion matches {int(nm)}, "
          f"motion inl {int(ninl1)}, local adds {int(n_new)}")
    basin(m, "motion-only set")
    basin(m1, "motion post-strip")
    basin(merged, "merged PRE-strip")
    # contamination of merged: reproj at GT
    from orbslam_mapsave_tpu.geometry import projection
    ok = np.asarray(merged) >= 0
    pc = se3.transform_points(jnp.asarray(Tgt), st.pt_pos[jnp.clip(merged, 0)])
    uv, _ = projection.project(sysm.cam, pc)
    err = np.linalg.norm(np.asarray(uv) - np.asarray(fr.kp_xy), axis=1)[ok]
    print(f"merged reproj@GT: med={np.median(err):.2f} p90="
          f"{np.percentile(err, 90):.2f} frac>3px={np.mean(err > 3):.3f}")


if __name__ == "__main__":
    main()
