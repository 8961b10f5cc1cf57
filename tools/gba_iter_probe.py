"""Chained device time of one incremental-GBA LM iteration at bench shapes."""
import os, sys, time
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import jax, jax.numpy as jnp, numpy as np
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
import bench as bench_mod
from orbslam_mapsave_tpu import config as config_mod
from orbslam_mapsave_tpu.pipeline import system as system_mod
from orbslam_mapsave_tpu.optim import global_ba

data = bench_mod.get_sequence()
voc = bench_mod.get_vocabulary(data, config_mod, system_mod)
slam = bench_mod.make_system(voc, config_mod, system_mod)
frames_dev = [(jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
              for g, d in data["frames"][:160]]
jax.block_until_ready(frames_dev)
for i, (g, d) in enumerate(frames_dev):
    slam.track_rgbd(g, d, 1000.0 + i / 30.0)
slam.tracker.flush(); slam.flush_gba()
state = slam.tracker.map
print("kfs", slam.n_keyframes, "pts", slam.n_points, flush=True)

trivial = jax.jit(lambda x: x + 1.0)
jax.block_until_ready(trivial(jnp.float32(1.0)))
ts = []
for _ in range(9):
    t0 = time.perf_counter(); jax.block_until_ready(trivial(jnp.float32(1.0)))
    ts.append(time.perf_counter() - t0)
RTT = float(np.median(ts)); print(f"rtt {RTT*1e3:.1f} ms", flush=True)

isig = jnp.asarray(slam.builder.inv_level_sigma2)
tb, carry = global_ba.gba_init(slam.cam, state, isig)
jax.block_until_ready(carry)

CH = 10
@jax.jit
def chain(carry):
    def body(c, _):
        return global_ba.gba_iterate(slam.cam, tb, *c), None
    c, _ = jax.lax.scan(body, carry, None, length=CH)
    return c[3]
jax.block_until_ready(chain(carry))
best = 1e9
for _ in range(3):
    t0 = time.perf_counter(); jax.block_until_ready(chain(carry))
    best = min(best, time.perf_counter() - t0)
print(f"gba_iterate (dense, chained): {1e3*(best-RTT)/CH:.2f} ms/iter", flush=True)

# essential graph + correct-loop one-shot latency for context
lc = slam.loop_closer
kf = int(np.nonzero(np.asarray(state.kf_valid))[0][-1])
if lc._essential_device is not None:
    t0 = time.perf_counter()
    out = lc._essential_graph(state, kf, max(kf - 15, 0))
    jax.block_until_ready(out.pt_pos)
    print(f"essential_graph (1x blocked, incl rtt): {1e3*(time.perf_counter()-t0):.1f} ms", flush=True)
