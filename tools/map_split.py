"""Time the pieces of the in-step mapping pass (LocalMapper._map_step)."""
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
from orbslam_mapsave_tpu.optim import local_ba

data = bench_mod.get_sequence()
slam = bench_mod.make_system(None, config_mod, system_mod)
frames_dev = [(jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
              for g, d in data["frames"][:100]]
jax.block_until_ready(frames_dev)
for i, (g, d) in enumerate(frames_dev):
    slam.track_rgbd(g, d, 1000.0 + i / 30.0)
slam.tracker.flush()
state = slam.tracker.map
mapper = slam.mapper
kf = jnp.asarray(int(np.nonzero(np.asarray(state.kf_valid))[0][-1]), jnp.int32)
print("kfs", slam.n_keyframes, "pts", slam.n_points)

REP = 10


def t(name, fn):
    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(REP):
        out = fn()
    jax.block_until_ready(out)
    print(f"{name:26s} {1e3*(time.perf_counter()-t0)/REP:8.2f} ms")
    return out


recent = jnp.asarray(0, jnp.int32)
t("full _map_step", lambda: mapper._map_step(state, kf, recent, jnp.asarray(False)))

cull = jax.jit(lambda s: lmod.recent_point_culling(s, jnp.ones(s.pt_capacity, bool) & s.pt_valid, kf, False))
t("recent_point_culling", lambda: cull(state))

tri = mapper.triangulate_pair
neigh = ms.covisible_keyframes(state, kf, mapper.n_tri_neighbors)
t("triangulation scan", lambda: jax.jit(tri.batched)(state, kf, neigh))

f_ba = jax.jit(lambda s: lmod.build_local_ba_problem(s, kf, slam.cam, mapper.inv_level_sigma2))
prob, cam_slots, lidx = t("build_ba_problem", lambda: f_ba(state))
f_solve = jax.jit(lambda p: local_ba.local_bundle_adjustment(slam.cam, p, abort=jnp.asarray(False)))
t("local BA solve", lambda: f_solve(prob))
t("keyframe_culling", lambda: lmod.keyframe_culling(state, kf))

bounds = slam.builder.bounds
sf = slam.builder.scale_factors
cand = jnp.arange(4096, dtype=jnp.int32)
f_fuse = jax.jit(lambda s: lmod.fuse_into_keyframe(
    s, kf, cand, slam.cam, bounds, sf, mapper.inv_level_sigma2, 4, 1.5))
t("one fuse pass", lambda: f_fuse(state))

# --- loop-closing per-KF cost (round 4) ---
import bench as bench_mod2
voc = bench_mod2.get_vocabulary(data, config_mod, system_mod)
slam2 = bench_mod2.make_system(voc, config_mod, system_mod)
for i, (g, d) in enumerate(frames_dev):
    slam2.track_rgbd(g, d, 1000.0 + i / 30.0)
slam2.tracker.flush()
state2 = slam2.tracker.map
lc = slam2.loop_closer
import jax.numpy as jnp2
kf2 = int(np.nonzero(np.asarray(state2.kf_valid))[0][-1])
bow = lc.compute_bow(state2, kf2)
jax.block_until_ready(bow)
t("compute_bow", lambda: lc.compute_bow(state2, kf2))
from orbslam_mapsave_tpu.pipeline.loop_closing import _detect_device
t("detect_device", lambda: _detect_device(lc.bow_store, state2, bow[0],
                                          bow[1], jnp2.asarray(kf2)))
t("add_kf_bow_sparse", lambda: __import__(
    'orbslam_mapsave_tpu.vocab.database', fromlist=['x']
).add_keyframe_bow_sparse(lc.bow_store, kf2, *bow))
