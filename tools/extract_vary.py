"""Extraction timing with VARYING inputs (detects runtime memoization of
identical (program, input) pairs) + per-stage split over distinct frames."""
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
import jax.numpy as jnp

import bench as bench_mod
from orbslam_mapsave_tpu.ops import orb

data = bench_mod.get_sequence()
W, H = bench_mod.W, bench_mod.H
spec = orb.ORBSpec.create(H, W, n_features=2000, n_levels=4,
                          scale_factor=1.5, max_kp=2048)
imgs = [jnp.asarray(g, jnp.float32) for g, _ in data["frames"][:50]]
jax.block_until_ready(imgs)

run = jax.jit(lambda im: orb.extract(spec, im))


def t(name, fn, rep):
    jax.block_until_ready(fn(0))
    t0 = time.perf_counter()
    out = None
    for i in range(rep):
        out = fn(i)
    jax.block_until_ready(out)
    print(f"{name:30s} {1e3*(time.perf_counter()-t0)/rep:8.3f} ms",
          flush=True)


t("extract SAME frame", lambda i: run(imgs[0]), 50)
t("extract DISTINCT frames", lambda i: run(imgs[i % 50]), 50)

f_pyr = jax.jit(lambda im: orb.build_pyramid(spec, im))
t("pyramid distinct", lambda i: f_pyr(imgs[i % 50]), 50)
pyrs = [f_pyr(im) for im in imgs[:20]]
jax.block_until_ready(pyrs)
ls = spec.levels[0]
f_score = jax.jit(lambda p: orb.fast_score_map(
    p[orb.EDGE:orb.EDGE + ls.height, orb.EDGE:orb.EDGE + ls.width],
    spec.min_th))
t("fast_score L0 distinct", lambda i: f_score(pyrs[i % 20][0]), 50)
f_det = jax.jit(lambda p: orb.detect_level(spec, ls, p))
t("detect L0 distinct", lambda i: f_det(pyrs[i % 20][0]), 50)
f_ic = jax.jit(orb.ic_moment_maps)
t("ic_moments L0 distinct", lambda i: f_ic(pyrs[i % 20][0]), 50)
f_blur = jax.jit(orb.gaussian_blur7)
t("blur L0 distinct", lambda i: f_blur(pyrs[i % 20][0]), 50)
xy, score = f_det(pyrs[0][0])
sel = jax.lax.top_k(score, ls.budget)[1]
xys = xy[sel]
blur0 = f_blur(pyrs[0][0])
ang = jax.jit(orb.ic_angles)(pyrs[0][0], xys)
f_brief = jax.jit(orb.brief_descriptors)
jax.block_until_ready((xys, blur0, ang))
t("brief L0 distinct-ish", lambda i: f_brief(blur0, xys, ang + i * 0.001), 50)
