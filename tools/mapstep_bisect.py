"""Bisect LocalMapper._map_step: rebuild the composed program with stages
progressively enabled, chain 20x, report marginal cost per stage."""
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
from orbslam_mapsave_tpu.pipeline import local_mapping as lmod
from orbslam_mapsave_tpu.slammap import mapstate as ms

CH = 20
data = bench_mod.get_sequence()
voc = bench_mod.get_vocabulary(data, config_mod, system_mod)
slam = bench_mod.make_system(voc, config_mod, system_mod)
frames_dev = [(jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
              for g, d in data["frames"][:110]]
jax.block_until_ready(frames_dev)
for i, (g, d) in enumerate(frames_dev):
    slam.track_rgbd(g, d, 1000.0 + i / 30.0)
slam.tracker.flush()
state = slam.tracker.map
mapper = slam.mapper
kf = int(np.nonzero(np.asarray(state.kf_valid))[0][-1])
kfj = jnp.asarray(kf, jnp.int32)

trivial = jax.jit(lambda x: x + 1.0)
jax.block_until_ready(trivial(jnp.float32(1.0)))
ts = []
for _ in range(9):
    t0 = time.perf_counter()
    jax.block_until_ready(trivial(jnp.float32(1.0)))
    ts.append(time.perf_counter() - t0)
RTT = float(np.median(ts))
print(f"rtt {RTT*1e3:.1f} ms", flush=True)

inv2 = mapper.inv_level_sigma2
cam = slam.cam
bounds = slam.builder.bounds
sf = jnp.asarray(slam.builder.scale_factors)
tri = mapper.triangulate_pair
n_tri = mapper.n_tri_neighbors
FUSE_CAP = lmod.FUSE_CAP
N_REV_FUSE = lmod.N_REV_FUSE


def make_step(upto):
    def step(st, kf_slot):
        P = st.pt_capacity
        recent = (jnp.arange(P) >= 0) & (jnp.arange(P) < st.n_pt)
        st = lmod.recent_point_culling(st, recent, kf_slot, False)
        if upto == "cull":
            return st
        neigh = ms.covisible_keyframes(st, kf_slot, n_tri)
        st, slots = tri.batched(st, kf_slot, neigh)
        st = tri.finalize_idx(st, jnp.clip(slots, 0), slots >= 0)
        st = ms.update_connections(st, kf_slot)
        if upto == "tri":
            return st
        nb_safe = jnp.clip(neigh, 0)
        pts_nb = jnp.where((neigh >= 0)[:, None], st.kf_kp_point[nb_safe], -1)
        flat = pts_nb.reshape(-1)
        flag = jnp.zeros(P, jnp.int8).at[jnp.clip(flat, 0)].max(
            jnp.where(flat >= 0, jnp.int8(1), jnp.int8(0)))
        flag = jnp.where(st.pt_valid, flag, 0)
        cand = ms.compact_indices(flag, min(FUSE_CAP, P))
        st = lmod.fuse_into_keyframe(st, kf_slot, cand, cam, bounds, sf,
                                     inv2, 4, 1.5)
        if upto == "fusefwd":
            return st
        own_pts = st.kf_kp_point[kf_slot]
        n_rev = min(N_REV_FUSE, int(neigh.shape[0]))
        N = own_pts.shape[0]

        def match_neighbor(i, wins):
            nb = neigh[i]

            def do(_):
                return lmod.fuse_match(st, nb, own_pts, cam, bounds, sf,
                                       inv2, 4, 1.5)
            w = jax.lax.cond(nb >= 0, do,
                             lambda _: jnp.full((N,), -1, jnp.int32), None)
            return wins.at[i].set(w)

        wins = jax.lax.fori_loop(0, n_rev, match_neighbor,
                                 jnp.full((n_rev, N), -1, jnp.int32))
        if upto == "revmatch":
            # consume wins trivially but dependently
            return st._replace(pt_pos=st.pt_pos.at[0, 0].add(
                jnp.sum(wins).astype(jnp.float32) * 1e-30))
        nb_rows = jnp.broadcast_to(neigh[:n_rev, None], (n_rev, N)).reshape(-1)
        feat_rows = jnp.broadcast_to(
            jnp.arange(N, dtype=jnp.int32)[None, :], (n_rev, N)).reshape(-1)
        wflat = wins.reshape(-1)
        cand_pt = jnp.where(wflat >= 0, own_pts[jnp.clip(wflat, 0)], -1)
        cand_pt = jnp.where((cand_pt >= 0) & (nb_rows >= 0)
                            & st.pt_valid[jnp.clip(cand_pt, 0)], cand_pt, -1)
        existing = st.kf_kp_point[jnp.clip(nb_rows, 0), feat_rows]
        obs_cnt = jnp.sum((st.pt_obs_kf >= 0).astype(jnp.int32), -1)
        mergeable = (cand_pt >= 0) & (existing >= 0) & (existing != cand_pt)
        keep_exist = obs_cnt[jnp.clip(existing, 0)] > obs_cnt[jnp.clip(cand_pt, 0)]
        src = jnp.where(mergeable, jnp.where(keep_exist, cand_pt, existing), -1)
        dst = jnp.where(mergeable, jnp.where(keep_exist, existing, cand_pt), -1)
        rows = jnp.arange(src.shape[0], dtype=jnp.int32)
        first_of_src = jnp.full(P, 1 << 30, jnp.int32).at[
            jnp.where(src >= 0, src, P - 1)].min(
            jnp.where(src >= 0, rows, 1 << 30), mode="drop")
        is_first = (src >= 0) & (first_of_src[jnp.clip(src, 0)] == rows)
        src_flag = jnp.zeros(P + 1, bool).at[
            jnp.where(src >= 0, src, P)].set(True)[:P]
        first_of_dst = jnp.full(P, 1 << 30, jnp.int32).at[
            jnp.where(dst >= 0, dst, P - 1)].min(
            jnp.where(dst >= 0, rows, 1 << 30), mode="drop")
        dst_first = (dst >= 0) & (first_of_dst[jnp.clip(dst, 0)] == rows)
        ok_pair = is_first & dst_first & ~src_flag[jnp.clip(dst, 0)]
        src = jnp.where(ok_pair, src, -1)
        dst = jnp.where(ok_pair, dst, -1)
        st = ms.merge_points(st, src, dst, ok_pair)
        addable = (cand_pt >= 0) & (existing < 0) & st.pt_valid[jnp.clip(cand_pt, 0)]
        blk = rows // N
        dupkey = jnp.where(addable, blk * P + cand_pt, n_rev * P)
        first_of_pair = jnp.full(n_rev * P + 1, 1 << 30, jnp.int32).at[
            dupkey].min(jnp.where(addable, rows, 1 << 30), mode="drop")
        addable = addable & (first_of_pair[
            jnp.clip(blk * P + cand_pt, 0, n_rev * P)] == rows)
        st = ms.add_observations_rows_dup(
            st, nb_rows, jnp.where(addable, cand_pt, -1), feat_rows, addable)
        if upto == "revapply":
            return st
        own = st.kf_kp_point[kf_slot]
        st = ms.compute_distinctive_descriptors_idx(st, jnp.clip(own, 0),
                                                    own >= 0)
        st = ms.update_normal_and_depth_idx(st, jnp.clip(own, 0), own >= 0,
                                            sf, 4)
        st = ms.update_connections(st, kf_slot)
        if upto == "upkeep":
            return st
        st, d, e = mapper._ba(st, kf_slot, jnp.asarray(False))
        st = lmod.keyframe_culling(st, kf_slot)
        return st
    return step


prev = 0.0
for upto in ["cull", "tri", "fusefwd", "revmatch", "revapply", "upkeep",
             "full"]:
    step = make_step(upto)

    @jax.jit
    def run(st):
        def body(st, _):
            return step(st, kfj), None
        st, _ = jax.lax.scan(body, st, None, length=CH)
        return st.pt_pos[0, 0] + st.n_pt

    jax.block_until_ready(run(state))
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(state))
        best = min(best, time.perf_counter() - t0)
    cur = 1e3 * (best - RTT) / CH
    print(f"upto {upto:9s} {cur:7.2f} ms   (marginal {cur - prev:+6.2f})",
          flush=True)
    prev = cur
