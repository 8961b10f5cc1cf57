"""Diagnose tracking loss on the bench workload: per-frame inliers/state."""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, "/root/repo")
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
import bench as bench_mod
from orbslam_mapsave_tpu import config as config_mod
from orbslam_mapsave_tpu.pipeline import system as system_mod

data = bench_mod.get_sequence()
slam = bench_mod.make_system(None, config_mod, system_mod)
slam.tracker.fetch_every = 1  # per-frame outcome fetch for diagnosis

N = bench_mod.N_FRAMES
for i in range(N):
    g, d = data["frames"][i]
    slam.track_rgbd(jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32),
                    1000.0 + i / 30.0)
    trk = slam.tracker
    if i % 5 == 0 or trk.state != 2 or i >= 110:
        st = trk.map
        ref = int(trk.ctrl.ref_kf)
        pts = np.asarray(st.kf_kp_point[ref])
        has = (pts >= 0) & np.asarray(st.kf_kp_valid[ref])
        obs = np.asarray(st.pt_obs_kf[np.clip(pts, 0, None)])
        nobs = (obs >= 0).sum(-1)
        rm3 = int((has & (nobs >= 3)).sum())
        rm2 = int((has & (nobs >= 2)).sum())
        rm_all = int(has.sum())
        tot_obs = int((np.asarray(st.pt_obs_kf) >= 0).sum())
        import collections
        hist = collections.Counter(nobs[has].tolist())
        print(f"f{i:3d} state={trk.state} inl={trk.n_inliers} ref={ref} "
              f"rm3={rm3} rm2={rm2} rm_all={rm_all} tot_obs={tot_obs} "
              f"hist={dict(sorted(hist.items())[:6])} "
              f"kf_wm={trk.n_kf_watermark} pt_wm={trk.n_pt_watermark}",
              flush=True)
    if i > 239:
        break
print("done: kfs", slam.n_keyframes, "pts", slam.n_points)
