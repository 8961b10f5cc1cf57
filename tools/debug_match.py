"""Gate-level introspection of search_by_projection_points at frame 10."""
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
from orbslam_mapsave_tpu.ops import hamming, matching
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
    cam = sysm.cam
    st = sysm.map
    ctrl = None
    N_TARGET = 10
    for i, (g, d) in enumerate(data["frames"][: N_TARGET + 1]):
        fr = sysm.builder.build(g, i / 30.0, d)
        if ctrl is None:
            ctrl = fused_step.initial_control_state(fr.kp_xy.shape[0], fr)
        if i == 0:
            st, kf, matched, _ = k["init_rgbd"](st, fr, jnp.asarray(0, jnp.int32))
            ctrl = ctrl._replace(ref_kf=kf, last_matched=matched, last_frame=fr)
            continue
        pose_pred = ctrl.velocity @ ctrl.pose if bool(ctrl.has_velocity) else ctrl.pose
        m, nm = k["track_motion"](st, fr, pose_pred, ctrl.last_matched,
                                  ctrl.last_frame, jnp.asarray(15.0, jnp.float32))
        pose1, m1, _ = k["optimize_pose"](st, fr, pose_pred, m)
        if i == N_TARGET:
            break
        local_idx, _ = k["gather_local_map"](st, m1, pose1)
        st, pose2, m2, n_inl = k["track_local_map"](
            st, fr, pose1, m1, local_idx, jnp.asarray(3.0, jnp.float32))
        ok2 = int(n_inl) >= 30
        vel = pose2 @ se3.se3_inv(ctrl.pose)
        ctrl = ctrl._replace(pose=pose2, velocity=vel,
                             has_velocity=jnp.asarray(ok2),
                             frame_id=ctrl.frame_id + 1,
                             last_matched=m2, last_frame=fr)

    # ---- introspect the local search at frame N_TARGET ----
    local_idx, _ = k["gather_local_map"](st, m1, pose1)
    lp = jnp.clip(local_idx, 0)
    lp_valid = (local_idx >= 0) & st.pt_valid[lp]
    already = jnp.zeros(st.pt_capacity, bool).at[jnp.clip(m1, 0)].set(m1 >= 0)
    lp_valid = lp_valid & ~already[lp]
    print("candidates (unmatched local pts):", int(jnp.sum(lp_valid)))

    pose = pose1
    ok, uv, _, dist, view_cos = matching.frustum_check(
        cam, pose, st.pt_pos[lp], st.pt_normal[lp], st.pt_min_dist[lp],
        st.pt_max_dist[lp], sysm.builder.bounds)
    ok = ok & lp_valid
    print("pass frustum:", int(jnp.sum(ok)))
    # which sub-gates fail?
    p_cam = se3.transform_points(pose, st.pt_pos[lp])
    z = p_cam[..., 2]
    in_img = (uv[..., 0] >= 0) & (uv[..., 0] < W) & (uv[..., 1] >= 0) & (uv[..., 1] < H)
    d_ok = (dist >= 0.8 * st.pt_min_dist[lp]) & (dist <= 1.2 * st.pt_max_dist[lp])
    v_ok = view_cos > 0.5
    print("  z>0:", int(jnp.sum(lp_valid & (z > 0))),
          " in_img:", int(jnp.sum(lp_valid & in_img)),
          " dist_band:", int(jnp.sum(lp_valid & d_ok)),
          " view_cos:", int(jnp.sum(lp_valid & v_ok)))

    lvl = matching.predict_scale(dist, st.pt_max_dist[lp], 1.5, 4)
    r = jnp.where(view_cos > 0.998, 2.5, 4.0)
    radius = 3.0 * r * sysm.builder.scale_factors[lvl]
    d2 = jnp.sum((uv[:, None, :] - fr.kp_xy[None, :, :]) ** 2, -1)
    in_win = d2 <= (radius[:, None] ** 2)
    oct_ok = (fr.kp_octave[None, :] >= (lvl - 1)[:, None]) & (
        fr.kp_octave[None, :] <= lvl[:, None])
    kp_free = fr.valid & ~(m1 >= 0)
    mask = in_win & oct_ok & kp_free[None, :] & ok[:, None]
    has_cand = mask.any(-1)
    print("have >=1 feature in window:", int(jnp.sum(has_cand)))
    pt_bits = hamming.unpack_bits(st.pt_desc[lp])
    dmat = hamming.hamming_matrix_bits(pt_bits, fr.desc_bits)
    idx, best, second = hamming.masked_best2(dmat, extra_mask=mask)
    print("best<=TH_HIGH(100):", int(jnp.sum(has_cand & (best <= 100))),
          "  best<=50:", int(jnp.sum(has_cand & (best <= 50))))
    ratio_pass = best.astype(jnp.float32) <= 0.8 * second.astype(jnp.float32)
    print("ratio pass:", int(jnp.sum(has_cand & (best <= 100) & ratio_pass)))
    good = ok & (best <= 100) & ratio_pass
    matches = matching._resolve_conflicts(idx, best, good, fr.kp_xy.shape[0])
    print("after conflict resolution:", int(jnp.sum(matches >= 0)))
    # distance distribution of best
    b = np.asarray(jnp.where(has_cand, best, -1))
    b = b[b >= 0]
    print("best-dist percentiles:", np.percentile(b, [10, 50, 90]).round(0))


if __name__ == "__main__":
    main()
