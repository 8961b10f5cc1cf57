"""ATE decomposition on the bench workload: where does the 0.0168 m come
from — front-end drift, essential-graph residual, or GBA convergence?"""
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
import jax.numpy as jnp
import numpy as np

import bench as bench_mod
from orbslam_mapsave_tpu import config as config_mod
from orbslam_mapsave_tpu.io import trajectory as traj_io
from orbslam_mapsave_tpu.optim import global_ba
from orbslam_mapsave_tpu.pipeline import system as system_mod


def kf_ate(slam, state, gt_poses):
    valid = np.asarray(state.kf_valid)
    ts = np.asarray(state.kf_timestamp, np.float64)[valid] + (
        slam.tracker.ts_epoch or 0.0)
    est = np.linalg.inv(np.asarray(state.kf_pose)[valid])
    gt_ts = 1000.0 + np.arange(bench_mod.N_FRAMES) / 30.0
    return traj_io.ate_rmse(gt_ts, gt_poses, ts, est)


def main():
    data = bench_mod.get_sequence()
    voc = bench_mod.get_vocabulary(data, config_mod, system_mod)
    slam = bench_mod.make_system(voc, config_mod, system_mod)
    frames_dev = [(jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
                  for g, d in data["frames"]]
    jax.block_until_ready(frames_dev)
    gt = data["poses"]
    lc = slam.loop_closer

    stamps = {}
    orig_correct = lc._correct_loop
    orig_ess = lc._essential_graph

    def wrap_corr(state, kf, match_kf, S, matched_pt, loop_pts):
        stamps.setdefault("pre_correct", kf_ate(slam, state, gt))
        return orig_correct(state, kf, match_kf, S, matched_pt, loop_pts)

    def wrap_ess(state, kf, match_kf):
        out = orig_ess(state, kf, match_kf)
        jax.block_until_ready(out.kf_pose)
        stamps.setdefault("post_essential", kf_ate(slam, out, gt))
        return out

    lc._correct_loop = wrap_corr
    lc._essential_graph = wrap_ess

    for i in range(bench_mod.N_FRAMES):
        g, d = frames_dev[i]
        slam.track_rgbd(g, d, 1000.0 + i / 30.0)
    slam.tracker.flush()
    # capture pre-GBA-apply state
    state_pre_gba = slam.map
    stamps["pre_gba_apply"] = kf_ate(slam, state_pre_gba, gt)
    slam.flush_gba()
    stamps["final (iters=10,cg=30)"] = kf_ate(slam, slam.map, gt)

    print({k: round(v, 4) for k, v in stamps.items()}, flush=True)
    print("loops:", len(lc.events), "kfs:", slam.n_keyframes, flush=True)

    ils2 = slam.builder.inv_level_sigma2
    for (it, cg, rb) in [(10, 100, False), (20, 100, False),
                         (20, 200, False), (15, 60, True)]:
        t0 = time.perf_counter()
        poses, pts, cost = global_ba.full_bundle_adjustment(
            slam.cam, state_pre_gba, jnp.asarray(ils2), n_iters=it,
            robust=rb, cg_iters=cg)
        jax.block_until_ready(poses)
        dt = time.perf_counter() - t0
        st = state_pre_gba._replace(kf_pose=poses, pt_pos=pts)
        print(f"GBA it={it} cg={cg} robust={rb}: ate={kf_ate(slam, st, gt):.4f}"
              f" cost={float(cost):.1f} ({dt*1e3:.0f} ms incl compile)",
              flush=True)


if __name__ == "__main__":
    main()
