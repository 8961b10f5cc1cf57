"""Bisect fuse_into_keyframe cost: match-only vs apply pieces."""
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

data = bench_mod.get_sequence()
slam = bench_mod.make_system(None, config_mod, system_mod)
frames_dev = [(jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
              for g, d in data["frames"][:100]]
jax.block_until_ready(frames_dev)
for i, (g, d) in enumerate(frames_dev):
    slam.track_rgbd(g, d, 1000.0 + i / 30.0)
slam.tracker.flush()
state = slam.tracker.map
kf = jnp.asarray(int(np.nonzero(np.asarray(state.kf_valid))[0][-1]), jnp.int32)
bounds = slam.builder.bounds
sf = slam.builder.scale_factors
ils2 = slam.mapper.inv_level_sigma2
cand = state.kf_kp_point[kf]  # (N,) reverse-fuse shape

REP = 30


def t(name, fn):
    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(REP):
        out = fn()
    jax.block_until_ready(out)
    print(f"{name:34s} {1e3*(time.perf_counter()-t0)/REP:8.2f} ms",
          flush=True)


f_full = jax.jit(lambda s: lmod.fuse_into_keyframe(
    s, kf, cand, slam.cam, bounds, sf, ils2, 4, 1.5))
t("fuse full", lambda: f_full(state))

f_match = jax.jit(lambda s: lmod.fuse_match(
    s, kf, cand, slam.cam, bounds, sf, ils2, 4, 1.5))
t("fuse match only", lambda: f_match(state))

win = f_match(state)
jax.block_until_ready(win)
f_apply = jax.jit(lambda s, w: lmod.fuse_apply(s, kf, cand, w))
t("fuse apply only", lambda: f_apply(state, win))

# apply pieces
f_merge = jax.jit(lambda s, w: ms.merge_points(
    s, jnp.where(w >= 0, s.kf_kp_point[kf], -1),
    jnp.where(w >= 0, cand[jnp.clip(w, 0)], -1),
    (w >= 0)))
t("merge_points alone", lambda: f_merge(state, win))

feat = jnp.arange(cand.shape[0], dtype=jnp.int32)
f_addo = jax.jit(lambda s, w: ms.add_observations(
    s, kf, jnp.where(w >= 0, cand[jnp.clip(w, 0)], -1), feat, w >= 0))
t("add_observations alone", lambda: f_addo(state, win))

f_obs = jax.jit(lambda s: jnp.sum((s.pt_obs_kf >= 0).astype(jnp.int32), -1))
t("obs_cnt pass alone", lambda: f_obs(state))
