"""Time _map_step under parameter variants to locate the real costs."""
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
recent = jnp.asarray(0, jnp.int32)
ab = jnp.asarray(False)
REP = 20


def t(name, mapper):
    fn = mapper._map_step
    out = fn(state, kf, recent, ab)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(REP):
        out = fn(state, kf, recent, ab)
    jax.block_until_ready(out)
    print(f"{name:44s} {1e3*(time.perf_counter()-t0)/REP:8.2f} ms",
          flush=True)


def mk(**kw):
    return lmod.LocalMapper(
        slam.cam, slam.builder.inv_level_sigma2, is_mono=False,
        scale_factors=slam.builder.scale_factors, n_levels=4,
        scale_factor=1.5, **kw)


t("baseline", mk())
t("no triangulation (tri+fuse off)", mk(enable_triangulation=False))
t("no culling (kf-cull off)", mk(enable_culling=False))

orig_fc = lmod.FUSE_CAP
lmod.FUSE_CAP = 2048
t("FUSE_CAP 2048", mk())
lmod.FUSE_CAP = orig_fc

orig_oba = lmod.O_BA
lmod.O_BA = 8
t("O_BA 8", mk())
lmod.O_BA = orig_oba

orig_l = lmod.L_CAP
lmod.L_CAP = 2048
t("L_CAP 2048", mk())
lmod.L_CAP = orig_l

orig_c = lmod.C_CAP
lmod.C_CAP = 32
t("C_CAP 32", mk())
lmod.C_CAP = orig_c

orig_r = lmod.N_REV_FUSE
lmod.N_REV_FUSE = 1
t("N_REV_FUSE 1", mk())
lmod.N_REV_FUSE = 0
t("N_REV_FUSE 0", mk())
lmod.N_REV_FUSE = orig_r
