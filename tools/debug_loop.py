"""Debug driver for the loop-closing chain on the synthetic circle."""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")
import numpy as np

sys.path.insert(0, "/root/repo")
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
from orbslam_mapsave_tpu import config as config_mod
from orbslam_mapsave_tpu.io import dataset, synthetic, trajectory
from orbslam_mapsave_tpu.pipeline import system as system_mod
from orbslam_mapsave_tpu.vocab import vocabulary, database
import jax.numpy as jnp

W, H = 320, 240
FX = 200.0
N_FRAMES = 170
T0 = 1000.0

root = "/tmp/loop_seq_dbg2"
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
poses = synthetic.circle_trajectory(N_FRAMES, radius=0.55, revs=1.30)
if not os.path.exists(root + "/rgb.txt"):
    synthetic.write_tum_sequence(
        root, K, poses, width=W, height=H, seed=11, depth_factor=5000.0,
        t0=T0, fps=30.0,
        depth_scale_fn=lambda i: 1.0 + 0.04 * np.sin(2 * np.pi * i / N_FRAMES),
    )


def make_system(voc):
    cfg = config_mod.SystemConfig()
    cfg.camera = config_mod.CameraConfig(
        fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H,
        bf=FX * 0.08, th_depth=50.0, depth_map_factor=5000.0, fps=30,
    )
    cfg.orb = config_mod.ORBConfig(n_features=500, n_levels=4, scale_factor=1.5)
    cfg.max_keypoints = 640
    cfg.max_keyframes = 48
    cfg.max_points = 16384
    return system_mod.SLAMSystem(
        cfg, system_mod.Sensor.RGBD, vocabulary=voc,
        enable_loop_closing=voc is not None, enable_mapping=True,
    )


sys_ = make_system(None)
ds = dataset.TUMDataset(root, depth_factor=5000.0)
descs = []
for i, (t, gray, depth) in enumerate(ds):
    if i % 10 != 0:
        continue
    fr = sys_.builder.build(gray, t, depth)
    d = np.asarray(fr.desc)[np.asarray(fr.valid)]
    descs.append(d)
voc = vocabulary.train(np.concatenate(descs), k=10, L=4, seed=1)
print("vocab words:", voc.n_words)

sys_ = make_system(voc)
lc = sys_.loop_closer

# instrument each stage
orig_detect = lc._detect_loop
orig_sim3 = lc._compute_sim3


def detect(state, kf, bow):
    covis = np.asarray(
        __import__("orbslam_mapsave_tpu.slammap.mapstate", fromlist=["covisible_keyframes"]
                   ).covisible_keyframes(state, kf, 30))
    covis = covis[covis >= 0]
    qw, qv = bow
    scores = np.asarray(database.sparse_score_rows(
        lc.bow_store, jnp.asarray(covis), qw, qv)) \
        if len(covis) else np.zeros(0)
    min_score = float(scores.min()) if len(scores) else 0.0
    keep, all_scores = database.detect_loop_candidates_sparse(
        lc.bow_store, state, qw, qv, jnp.asarray(kf),
        jnp.asarray(min_score, jnp.float32))
    cand = np.nonzero(np.asarray(keep))[0]
    out = orig_detect(state, kf, bow)
    print(f"KF {kf}: min_score={min_score:.3f} cands={list(cand)} "
          f"groups={[(sorted(g)[:3], c) for g, c in lc.consistent_groups][:6]} "
          f"-> {out}")
    return out


def sim3(state, kf, cand):
    out = orig_sim3(state, kf, cand)
    print(f"  sim3 {kf} vs {cand}: {'FAIL' if out is None else 'OK n=%d total' % out[2]}")
    return out


lc._detect_loop = detect
lc._compute_sim3 = sim3



ds = dataset.TUMDataset(root, depth_factor=5000.0)
n_ok = 0
for i, (t, gray, depth) in enumerate(ds):
    pose = sys_.track_rgbd(gray, depth, t)
    n_ok += pose is not None
sys_.flush_gba()
print("tracked", n_ok, "/", N_FRAMES, "kfs:", sys_.n_keyframes,
      "pts:", sys_.n_points, "events:", lc.events)

valid = np.asarray(sys_.map.kf_valid)
ts = np.asarray(sys_.map.kf_timestamp)[valid]
est = np.linalg.inv(np.asarray(sys_.map.kf_pose)[valid])
gt_ts = T0 + np.arange(N_FRAMES) / 30.0
print("final KF ATE:", trajectory.ate_rmse(gt_ts, poses, ts, est))
