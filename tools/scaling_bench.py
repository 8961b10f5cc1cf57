"""Strong-scaling measurement of the distributed full-map GBA.

Runs the keyframe-block sharded BA (parallel/dist_gba.py) on a fixed
problem (C keyframes, L landmarks) over 1/2/4/8 devices of the mesh and
reports wall time + parallel efficiency.

CAVEAT recorded with the results: on this box the mesh is
`xla_force_host_platform_device_count` VIRTUAL CPU devices sharing one
physical socket, so compute does not speed up with the mesh — the number
measures sharding/collective OVERHEAD (efficiency ~1/n is expected on CPU;
on real cards per-device compute shrinks by 1/n and the collectives
ride NVLink). Usage: python tools/scaling_bench.py [C] [L]
"""
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))

from orbslam_mapsave_tpu.parallel import dist_gba  # noqa: E402
from tests.test_global_ba import make_map_state  # noqa: E402


def main():
    C = int(sys.argv[1]) if len(sys.argv) > 1 else 192
    L = int(sys.argv[2]) if len(sys.argv) > 2 else 49152
    rng = np.random.default_rng(7)
    cam, state, poses_true, _ = make_map_state(
        rng, n_kf=C, n_pt=L, kf_cap=C, pt_cap=L, obs_per_pt=6,
        noise=0.3, pose_noise=0.04, n_feat=2048)
    isig = jnp.ones(4, jnp.float32)
    results = []
    t1 = None
    for n in (1, 2, 4, 8):
        if len(jax.devices()) < n:
            break
        mesh = dist_gba.make_mesh(n)
        # warm (compile)
        out = dist_gba.distributed_full_ba(cam, state, isig, mesh,
                                           n_iters=4, cg_iters=40)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        out = dist_gba.distributed_full_ba(cam, state, isig, mesh,
                                           n_iters=4, cg_iters=40)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        if t1 is None:
            t1 = dt
        eff = t1 / (dt * n)
        results.append({"devices": n, "seconds": round(dt, 3),
                        "speedup": round(t1 / dt, 3),
                        "efficiency": round(eff, 3)})
        print(f"n={n}: {dt:.3f}s speedup={t1/dt:.2f} eff={eff:.2f}",
              file=sys.stderr)
    print(json.dumps({
        "problem": {"C": C, "L": L, "iters": 4, "cg_iters": 40},
        "hardware": "virtual CPU mesh (xla_force_host_platform_device_count)",
        "note": "virtual devices share one socket: this measures sharding "
                "overhead, not device scaling; see module docstring",
        "results": results,
    }))


if __name__ == "__main__":
    main()
