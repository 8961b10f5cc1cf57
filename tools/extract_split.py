"""Per-stage timing of ORB extraction on the current backend."""
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
from orbslam_mapsave_tpu.ops import orb

data = bench_mod.get_sequence()
W, H = bench_mod.W, bench_mod.H
spec = orb.ORBSpec.create(H, W, n_features=2000, n_levels=4, scale_factor=1.5,
                          max_kp=2048)
img = jnp.asarray(data["frames"][0][0], jnp.float32)
jax.device_get(jnp.zeros(()))  # initialize the backend outside the timings
REP = 50


def t(name, fn):
    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    outs = None
    for _ in range(REP):
        outs = fn()
    jax.block_until_ready(outs)
    dt = (time.perf_counter() - t0) / REP
    print(f"{name:28s} {1e3*dt:7.3f} ms")
    return out


f_pyr = jax.jit(lambda im: orb.build_pyramid(spec, im))
t("build_pyramid", lambda: f_pyr(img))
pyr = f_pyr(img)

for lvl, ls in enumerate(spec.levels):
    padded = pyr[lvl]
    f_score = jax.jit(lambda p: orb.fast_score_map(
        p[orb.EDGE:orb.EDGE + ls.height, orb.EDGE:orb.EDGE + ls.width],
        spec.min_th))
    t(f"fast_score L{lvl} {ls.height}x{ls.width}", lambda: f_score(padded))
    f_det = jax.jit(lambda p: orb.detect_level(spec, ls, p))
    xy, score = t(f"detect_level L{lvl}", lambda: f_det(padded))
    f_ic = jax.jit(orb.ic_moment_maps)
    t(f"ic_moments  L{lvl}", lambda: f_ic(padded))
    f_bl = jax.jit(orb.gaussian_blur7)
    blurred = t(f"blur7       L{lvl}", lambda: f_bl(padded))
    ang = jax.jit(orb.ic_angles)(padded, xy)
    f_br = jax.jit(orb.brief_descriptors)
    t(f"brief       L{lvl} C={xy.shape[0]}", lambda: f_br(blurred, xy, ang))

ext = orb.make_extractor(spec)
t("extract full", lambda: ext(img))
