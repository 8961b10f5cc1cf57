"""Split the bench workload's wall time into tracking / mapping+loop
backend / GBA, with warm persistent cache. Run AFTER bench.py (or any run
that populated the compile cache, utils/compile_cache)."""
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
from orbslam_mapsave_tpu import config as config_mod
from orbslam_mapsave_tpu.pipeline import system as system_mod

data = bench_mod.get_sequence()
voc = bench_mod.get_vocabulary(data, config_mod, system_mod)
frames_dev = [(jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
              for g, d in data["frames"]]
jax.block_until_ready(frames_dev)
N = len(frames_dev)

for rep in range(2):  # rep 0 = warmup/compile, rep 1 = measured
    slam = bench_mod.make_system(voc, config_mod, system_mod)
    lc = slam.loop_closer
    t_track = t_backend = t_loop_proc = t_poll = 0.0
    # monkeypatch timers around the backend pieces
    orig_run = slam._run_backends
    orig_proc = lc.process
    orig_poll = lc.poll_gba

    def timed_run():
        global t_backend
        t0 = time.perf_counter()
        orig_run()
        t_backend += time.perf_counter() - t0

    def timed_proc(state, kf):
        global t_loop_proc
        t0 = time.perf_counter()
        out = orig_proc(state, kf)
        jax.block_until_ready(out.pt_pos)
        t_loop_proc += time.perf_counter() - t0
        return out

    def timed_poll(state):
        global t_poll
        t0 = time.perf_counter()
        out = orig_poll(state)
        jax.block_until_ready(out.pt_pos)
        t_poll += time.perf_counter() - t0
        return out

    slam._run_backends = timed_run
    lc.process = timed_proc
    lc.poll_gba = timed_poll

    t0 = time.perf_counter()
    for i in range(N):
        g, d = frames_dev[i]
        tt = time.perf_counter()
        slam.tracker.track_rgbd(g, d, 1000.0 + i / 30.0)
        t_track += time.perf_counter() - tt
        timed_run()
    slam.tracker.flush()
    # restore poll_gba before timing the flush: flush_gba() calls it, so a
    # monkeypatched poll would double-count into both t_poll and
    # t_gba_flush (ADVICE r2)
    lc.poll_gba = orig_poll
    tg = time.perf_counter()
    slam.flush_gba()
    t_gba_flush = time.perf_counter() - tg
    total = time.perf_counter() - t0
    if rep == 1:
        print(f"total={total:.2f}s  enqueue(track+map)={t_track:.2f}s  "
              f"backend={t_backend:.2f}s (loop.process={t_loop_proc:.2f}s "
              f"poll_gba={t_poll:.2f}s)  flush_gba={t_gba_flush:.2f}s")
        print("kfs", slam.n_keyframes, "pts", slam.n_points,
              "loops", len(lc.events))
