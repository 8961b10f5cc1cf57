"""One-shot round-3 profile: late-map tracking kernels, frame build, fused
step, mapping pieces, GBA, and loop-event phases — single process."""
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
from orbslam_mapsave_tpu.pipeline import system as system_mod



def t(label, fn, n=10):
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n * 1000
    print(f"{label:42s} {dt:8.2f} ms", flush=True)
    return dt


def main():
    data = bench_mod.get_sequence()
    voc = bench_mod.get_vocabulary(data, config_mod, system_mod)
    slam = bench_mod.make_system(voc, config_mod, system_mod)
    print("transferring frames...", flush=True)
    t0 = time.perf_counter()
    frames_dev = [(jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
                  for g, d in data["frames"][:210]]
    jax.block_until_ready(frames_dev)
    print(f"transfer: {time.perf_counter()-t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    for i in range(205):
        g, d = frames_dev[i]
        slam.track_rgbd(g, d, 1000.0 + i / 30.0)
    slam.tracker.flush()
    print(f"drive 205 frames: {time.perf_counter()-t0:.1f}s", flush=True)
    print("kfs", slam.n_keyframes, "pts", slam.n_points,
          "loops", len(slam.loop_closer.events), flush=True)

    trk = slam.tracker
    state = trk.map
    ctrl = trk.ctrl
    g, d = frames_dev[205]

    print("--- per-frame path ---", flush=True)
    t("frame build (ORB extract)", lambda: trk.builder.build(g, 1006.8, d))
    fr = trk.builder.build(g, 1006.8, d)
    jax.block_until_ready(fr)
    t("FULL fused step", lambda: trk.step(state, ctrl, fr)[1].pose)

    kernels = trk.k
    pose_pred = ctrl.velocity @ ctrl.pose
    th = jnp.asarray(15.0, jnp.float32)
    no_temp = jnp.asarray(False)
    m, pw, have, nm = kernels["track_motion"](
        state, fr, pose_pred, ctrl.last_matched, ctrl.last_frame, th,
        ctrl.pose, no_temp)
    t("  track_motion", lambda: kernels["track_motion"](
        state, fr, pose_pred, ctrl.last_matched, ctrl.last_frame, th,
        ctrl.pose, no_temp))
    t("  optimize_pose_xyz", lambda: kernels["optimize_pose_xyz"](
        state, fr, pose_pred, pw, have, m))
    pose, mm, ninl, _ = kernels["optimize_pose_xyz"](
        state, fr, pose_pred, pw, have, m)
    t("  gather_local_map", lambda: kernels["gather_local_map"](state, mm, pose))
    local_idx, ref2 = kernels["gather_local_map"](state, mm, pose)
    t("  track_local_map", lambda: kernels["track_local_map"](
        state, fr, pose, mm, local_idx, jnp.asarray(3.0, jnp.float32)))

    print("--- GBA ---", flush=True)
    from orbslam_mapsave_tpu.optim import global_ba
    ils2 = trk.builder.inv_level_sigma2

    def gba(it, cg):
        return global_ba.full_bundle_adjustment(
            slam.cam, state, ils2, n_iters=it, robust=False, cg_iters=cg)[2]

    t("full GBA n_iters=10 cg=100", lambda: gba(10, 100), n=2)
    t("full GBA n_iters=10 cg=20", lambda: gba(10, 20), n=2)
    t("full GBA n_iters=4 cg=20", lambda: gba(4, 20), n=2)
    t("GBA 1 LM iter cg=100", lambda: gba(1, 100), n=2)
    t("GBA 1 LM iter cg=8", lambda: gba(1, 8), n=2)
    t("GBA build_tables only", lambda: jax.jit(
        lambda s: global_ba.build_tables(s, ils2).po_uv)(state), n=4)

    print("--- loop event phases ---", flush=True)
    lc = slam.loop_closer
    # instrument one full process() call on the next keyframe slot, timed
    # by phase via monkeypatching
    import orbslam_mapsave_tpu.pipeline.loop_closing as lcmod

    kf = int(np.nonzero(np.asarray(state.kf_valid))[0][-1])
    bow = lc.compute_bow(state, kf)
    jax.block_until_ready(bow)
    t("compute_bow", lambda: lc.compute_bow(state, kf))

    def detect():
        out = lcmod._detect_device(lc.bow_store, state, bow[0], bow[1],
                                   jnp.asarray(kf))
        return out[0]
    t("detect device program", detect)

    fut = lcmod._detect_device(lc.bow_store, state, bow[0], bow[1],
                               jnp.asarray(kf))
    cands = lc._detect_host(kf, fut)
    # _detect_host returns a candidate LIST; take the best for the probe
    cand = cands[0] if cands else None
    print("detect candidate:", cand, flush=True)
    t0 = time.perf_counter()
    res = lc._compute_sim3(state, kf, cand) if cand is not None else None
    print(f"_compute_sim3 (host path, 1x): "
          f"{1e3*(time.perf_counter()-t0):.1f} ms ok={res is not None}",
          flush=True)
    if res is not None:
        S_cur_loop, match_kf, n_inl, matched_pt, loop_pts = res
        t0 = time.perf_counter()
        st2 = lc._correct_loop(state, kf, match_kf, S_cur_loop, matched_pt,
                               loop_pts)
        jax.block_until_ready(st2.pt_pos)
        print(f"_correct_loop (1x, incl pose graph): "
              f"{1e3*(time.perf_counter()-t0):.1f} ms", flush=True)
        # phase split inside correct_loop: time essential graph alone
        t0 = time.perf_counter()
        st3 = lc._essential_graph(state, kf, match_kf)
        jax.block_until_ready(st3.pt_pos)
        print(f"_essential_graph alone (1x): "
              f"{1e3*(time.perf_counter()-t0):.1f} ms", flush=True)
        t0 = time.perf_counter()
        st3 = lc._essential_graph(state, kf, match_kf)
        jax.block_until_ready(st3.pt_pos)
        print(f"_essential_graph alone (2nd): "
              f"{1e3*(time.perf_counter()-t0):.1f} ms", flush=True)


if __name__ == "__main__":
    main()
