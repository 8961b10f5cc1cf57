"""Split per-frame cost: transfer/dispatch vs build vs track vs map.

Times each device program in isolation (block_until_ready on an idle
device) so the numbers are attributable, unlike wall-clock pipelining.
"""
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


def t(label, fn, n=10):
    fn()  # warm
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n * 1000
    print(f"{label:40s} {dt:8.2f} ms")
    return dt


def main():
    data = bench_mod.get_sequence()
    from orbslam_mapsave_tpu import config as config_mod
    from orbslam_mapsave_tpu.pipeline import system as system_mod

    W, H = bench_mod.W, bench_mod.H
    cfg = config_mod.SystemConfig()
    cfg.camera = config_mod.CameraConfig(
        fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, width=W, height=H,
        fps=30, bf=40.0, th_depth=40.0,
    )
    sysm = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD,
                                 enable_loop_closing=False)
    # run 12 frames to populate a real map
    for i in range(12):
        gray, depth = data["frames"][i]
        sysm.track_rgbd(gray, depth, i / 30.0)
    sysm.tracker.flush()
    jax.block_until_ready(sysm.map)
    print(f"map: kfs={sysm.n_keyframes} pts={sysm.n_points}")

    gray, depth = data["frames"][20]
    g = jnp.asarray(gray, jnp.float32)
    d = jnp.asarray(depth, jnp.float32)
    jax.block_until_ready((g, d))

    # 0. transfer cost
    t("h2d transfer (gray+depth)",
      lambda: (jnp.asarray(gray, jnp.float32), jnp.asarray(depth, jnp.float32)))
    # trivial dispatch
    f_triv = jax.jit(lambda x: x + 1.0)
    f_triv(g)
    t("trivial dispatch", lambda: f_triv(g))

    # 1. frame build from device-resident image
    fr = sysm.builder.build(g, 0.7, d)
    jax.block_until_ready(fr)
    t("frame.build", lambda: sysm.builder.build(g, 0.7, d))

    # 2. ORB extract alone
    from orbslam_mapsave_tpu.ops import orb
    t("orb.extract", lambda: orb.extract(sysm.spec, g))

    # 3. fused step, steady state (no KF expected: tracker just ran)
    ctrl = sysm.tracker.ctrl
    st = sysm.map
    step = sysm.tracker.step
    out = step(st, ctrl, fr)
    jax.block_until_ready(out)
    t("fused step (post-KF state)", lambda: step(st, ctrl, fr))

    # 4. force the mapping branch: replicate ctrl with stale last_kf id
    ctrl_kf = ctrl._replace(
        last_kf_frame_id=ctrl.frame_id - 100,
    )
    out2 = step(st, ctrl_kf, fr)
    jax.block_until_ready(out2)
    created = bool(out2[2].kf_created)
    t(f"fused step (kf_created={created})", lambda: step(st, ctrl_kf, fr))

    # 5. mapper pass alone on a real KF slot
    mp = sysm.mapper
    slot = jnp.asarray(int(np.asarray(sysm.map.n_kf)) - 1, jnp.int32)
    ms_ = mp._map_step(st, slot, jnp.asarray(0, jnp.int32), jnp.asarray(False))
    jax.block_until_ready(ms_)
    t("mapper._map_step", lambda: mp._map_step(
        st, slot, jnp.asarray(0, jnp.int32), jnp.asarray(False)))

    # 6. local BA alone
    ba = mp._ba(st, slot, jnp.asarray(False))
    jax.block_until_ready(ba)
    t("local BA", lambda: mp._ba(st, slot, jnp.asarray(False)))

    # 7. triangulation single pair
    if mp.triangulate_pair is not None:
        tri = mp.triangulate_pair
        o = tri(st, slot, jnp.asarray(0, jnp.int32))
        jax.block_until_ready(o)
        t("triangulate one pair", lambda: tri(st, slot, jnp.asarray(0, jnp.int32)))

    # 8. keyframe culling
    from orbslam_mapsave_tpu.pipeline import local_mapping as lm_mod
    o = lm_mod.keyframe_culling(st, slot)
    jax.block_until_ready(o)
    t("keyframe_culling", lambda: lm_mod.keyframe_culling(st, slot))


if __name__ == "__main__":
    main()
