import sys, os
sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))
import jax, jax.numpy as jnp, numpy as np
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
import bench as bench_mod
from orbslam_mapsave_tpu import config as config_mod
from orbslam_mapsave_tpu.pipeline import system as system_mod, local_mapping as lmod
from orbslam_mapsave_tpu.slammap import mapstate as ms

data = bench_mod.get_sequence()
slam = bench_mod.make_system(None, config_mod, system_mod)
frames_dev = [(jnp.asarray(g, jnp.float32), jnp.asarray(d, jnp.float32))
              for g, d in data["frames"][:230]]
jax.block_until_ready(frames_dev)
for i, (g, d) in enumerate(frames_dev):
    slam.track_rgbd(g, d, 1000.0 + i / 30.0)
slam.tracker.flush()
state = slam.tracker.map
kf = int(np.nonzero(np.asarray(state.kf_valid))[0][-1])
prob, cam_slots, lidx = lmod.build_local_ba_problem(
    state, jnp.asarray(kf), slam.cam, slam.builder.inv_level_sigma2)
print("live BA points:", int((np.asarray(lidx) >= 0).sum()), "/", lidx.shape[0])
print("live BA obs lanes:", int(np.asarray(prob.obs_valid).sum()),
      "/", prob.obs_valid.size)
ol = np.asarray(prob.obs_valid).sum(1)
print("obs/pt percentiles:", np.percentile(ol[np.asarray(lidx)>=0],[50,90,99,100]))
print("live cams:", int(np.asarray(prob.cam_valid).sum()), "/", cam_slots.shape[0])
# fuse candidate count
neigh = ms.covisible_keyframes(state, jnp.asarray(kf), 10)
nb = np.asarray(neigh)
pts_nb = np.asarray(state.kf_kp_point)[nb[nb>=0]]
flat = pts_nb.reshape(-1); flat = flat[flat>=0]
print("fwd fuse candidates (unique):", len(np.unique(flat)))
