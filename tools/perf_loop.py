"""Phase-level timing of loop events on the bench workload (round 3)."""
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



def main():
    data = bench_mod.get_sequence()
    voc = bench_mod.get_vocabulary(data, config_mod, system_mod)
    slam = bench_mod.make_system(voc, config_mod, system_mod)
    frames_dev = [(jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
                  for g, d in data["frames"]]
    jax.block_until_ready(frames_dev)

    lc = slam.loop_closer
    log = []

    def wrap(name, fn, sync=None):
        def inner(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync is not None:
                jax.block_until_ready(sync(out))
            log.append((name, time.perf_counter() - t0))
            return out
        return inner

    lc._detect_loop = wrap("detect_loop", lc._detect_loop)
    lc._compute_sim3 = wrap("compute_sim3", lc._compute_sim3)
    orig_correct = lc._correct_loop
    lc._correct_loop = wrap("correct_loop", orig_correct,
                            sync=lambda s: s.pt_pos)
    orig_eg = lc._essential_graph
    lc._essential_graph = wrap("essential_graph", orig_eg,
                               sync=lambda s: s.pt_pos)
    orig_bow = lc.compute_bow
    lc.compute_bow = wrap("compute_bow", orig_bow)
    import orbslam_mapsave_tpu.pipeline.gba as gba_mod
    orig_gba_init = gba_mod.GBAJob.__init__
    gba_mod.GBAJob.__init__ = wrap("gba_launch(async)", orig_gba_init)
    orig_apply = gba_mod.GBAJob.apply
    gba_mod.GBAJob.apply = wrap("gba_apply(blocks)", orig_apply,
                                sync=lambda s: s.pt_pos)

    t0 = time.perf_counter()
    for i in range(len(frames_dev)):
        g, d = frames_dev[i]
        slam.track_rgbd(g, d, 1000.0 + i / 30.0)
    slam.tracker.flush()
    slam.flush_gba()
    total = time.perf_counter() - t0
    print(f"total={total:.2f}s (cold-ish: in-process compiles included)",
          flush=True)
    agg = {}
    for name, dt in log:
        agg.setdefault(name, []).append(dt)
    for name, ds in agg.items():
        print(f"{name:22s} n={len(ds):3d} total={sum(ds):7.2f}s "
              f"max={max(ds)*1e3:8.1f}ms", flush=True)
    print("loops:", len(lc.events), "kfs", slam.n_keyframes, flush=True)

    # second call on same state: steady-state cost of the correction path
    if lc.events:
        state = slam.map
        kf = lc.events[-1].query_kf
        mk = lc.events[-1].match_kf
        for rep in range(2):
            t0 = time.perf_counter()
            st = orig_eg(state, kf, mk)
            jax.block_until_ready(st.pt_pos)
            print(f"essential_graph rerun{rep}: "
                  f"{1e3*(time.perf_counter()-t0):.1f}ms", flush=True)


if __name__ == "__main__":
    main()
