"""At each chained frame: compare the matched set's chi2 at the estimated
pose vs at the GT pose, and measure association agreement with a GT-seeded
run. Distinguishes broken-gate from wrong-association hypotheses."""
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
from orbslam_mapsave_tpu.geometry import se3, projection
from orbslam_mapsave_tpu.optim import pose_opt
from orbslam_mapsave_tpu.pipeline import system as system_mod, fused_step


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
    cam = trk.cam
    builder = sysm.builder

    st = sysm.map
    frames = [sysm.builder.build(g, i / 30.0, d)
              for i, (g, d) in enumerate(data["frames"][:16])]
    st, kf, matched, n_pts = k["init_rgbd"](st, frames[0],
                                            jnp.asarray(0, jnp.int32))

    def chi2_stats(pose, fr, m):
        ok = (m >= 0) & st.pt_valid[jnp.clip(m, 0)]
        obs = pose_opt.PoseObs(
            pt_w=st.pt_pos[jnp.clip(m, 0)], uv=fr.kp_xy, ur=fr.kp_ur,
            inv_sigma2=builder.inv_level_sigma2[jnp.clip(fr.kp_octave, 0)],
            valid=ok)
        _, _, _, chi2, is_st, behind = pose_opt._residuals(
            cam, jnp.asarray(pose, jnp.float32), obs)
        c = np.asarray(chi2)[np.asarray(ok)]
        gate = np.asarray(jnp.where(is_st, 7.815, 5.991))[np.asarray(ok)]
        return np.median(c), np.mean(c <= gate), int(ok.sum())

    def run_track(st, fr, pose_pred, last_matched, last_frame):
        m, nm = k["track_motion"](st, fr, pose_pred, last_matched, last_frame,
                                  jnp.asarray(tcfg.motion_th, jnp.float32))
        pose1, m1, ninl1 = k["optimize_pose"](st, fr, pose_pred, m)
        local_idx, ref2 = k["gather_local_map"](st, m1, pose1)
        st2, pose2, m2, n_inl = k["track_local_map"](
            st, fr, pose1, m1, local_idx,
            jnp.asarray(tcfg.local_th, jnp.float32))
        return m, pose2, m2, int(n_inl)

    pose_chain = jnp.eye(4)
    vel = jnp.eye(4)
    has_vel = False
    last_m, last_f = matched, frames[0]
    last_m_gt = matched
    print(" f | med_chi2(est) inl%(est) | med_chi2@GT inl%@GT | assoc agree | mot-assoc agree")
    for i in range(1, 16):
        fr = frames[i]
        gt_rel = gt_Tcw[i] @ gt_Twc[0]
        pose_pred = vel @ pose_chain if has_vel else pose_chain
        m_mot, p2, m2, ninl = run_track(st, fr, pose_pred, last_m, last_f)
        gm_mot, gp2, gm2, gninl = run_track(st, fr, jnp.asarray(gt_rel),
                                            last_m_gt, frames[i - 1])
        med_e, frac_e, n_e = chi2_stats(p2, fr, m2)
        med_g, frac_g, _ = chi2_stats(gt_rel, fr, m2)
        # association agreement on features matched in both
        a, b = np.asarray(m2), np.asarray(gm2)
        both = (a >= 0) & (b >= 0)
        agree = np.mean(a[both] == b[both]) if both.any() else float("nan")
        am, bm = np.asarray(m_mot), np.asarray(gm_mot)
        bothm = (am >= 0) & (bm >= 0)
        agreem = np.mean(am[bothm] == bm[bothm]) if bothm.any() else float("nan")
        d = np.asarray(p2) @ np.linalg.inv(gt_rel)
        ang = np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))
        print(f"f{i:02d} | {med_e:8.3f} {frac_e*100:5.1f}% n={n_e:4d} | "
              f"{med_g:8.3f} {frac_g*100:5.1f}% | {agree*100:5.1f}% | "
              f"{agreem*100:5.1f}% | ang={ang:5.2f}d")
        vel = p2 @ se3.se3_inv(pose_chain)
        pose_chain = p2
        has_vel = True
        last_m, last_f = m2, fr
        last_m_gt = gm2


if __name__ == "__main__":
    main()
