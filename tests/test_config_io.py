"""Tests for the YAML config cascade, dataset loaders, trajectory writers."""

from pathlib import Path

import numpy as np

from orbslam_mapsave_tpu import config
from orbslam_mapsave_tpu.geometry import se3
from orbslam_mapsave_tpu.io import dataset, synthetic, trajectory

# copies of the reference's settings files, in its own format
FIXTURES = Path(__file__).parent / "fixtures"
REFERENCE_CAM_YAML = FIXTURES / "ORB_RGBD640x480.yaml"
REFERENCE_SETTING_YAML = FIXTURES / "Setting.yaml"


def test_load_reference_camera_yaml():
    cfg = config.load_camera_settings(REFERENCE_CAM_YAML)
    assert cfg.camera.fx == 929.764
    assert cfg.camera.cy == 358.178
    assert cfg.camera.width == 1280
    assert cfg.camera.bf == 33.0
    assert cfg.camera.th_depth == 50.0
    assert cfg.camera.depth_map_factor == 1000.0
    assert cfg.orb.n_features == 2000
    assert cfg.orb.scale_factor == 1.5
    assert cfg.orb.n_levels == 4
    assert cfg.orb.ini_th_fast == 15
    assert cfg.orb.min_th_fast == 3
    assert cfg.viewer.trj_history == 10
    assert cfg.udp.port_in == 8008
    assert cfg.udp.ip_client == "146.169.195.98"
    assert cfg.aruco.marker_length == 0.053


def test_load_reference_master_yaml():
    cfg = config.load_master_settings(REFERENCE_SETTING_YAML)
    assert cfg.reuse_map is True
    assert cfg.use_viewer is False
    assert cfg.detect_human is True
    assert cfg.detect_marker is False
    assert cfg.vocabulary_path.endswith("ORBvoc.bin")


def test_synthetic_tum_roundtrip(synthetic_tum):
    ds = dataset.TUMDataset(synthetic_tum["root"])
    assert len(ds) == 12
    t, gray, depth = ds[0]
    assert gray.shape == (480, 640)
    assert depth.shape == (480, 640)
    # depth must be metrically correct: center pixel ray hits the +z wall
    # at distance (2 - cam_z); check within quantization error.
    Twc0 = synthetic_tum["poses"][0]
    assert abs(depth[240, 320] - (2.0 - Twc0[2, 3]) / Twc0[2, 2]) < 0.05
    assert ds.groundtruth_path is not None


def test_trajectory_writer_format(tmp_path):
    poses_cw = [np.eye(4), np.asarray(se3.se3_exp(np.array([0.1, 0, 0, 0, 0.05, 0])))]
    out = tmp_path / "traj.txt"
    trajectory.save_camera_trajectory(out, [1000.0, 1033.0], poses_cw)
    lines = out.read_text().splitlines()
    assert len(lines) == 2
    fields = lines[0].split(" ")
    assert len(fields) == 8
    # fixed precision 6, timestamp / 1e3 as in System.cc:747
    assert fields[0] == "1.000000"
    assert fields[7] == "1.000000"  # identity quaternion w
    ts, poses = trajectory.load_tum_trajectory(out)
    assert poses.shape == (2, 4, 4)


def test_ate_rmse_identity(synthetic_tum, tmp_path):
    poses = synthetic_tum["poses"]
    ts = 1000.0 + np.arange(len(poses)) / 30.0
    err = trajectory.ate_rmse(ts, poses, ts, poses)
    assert err < 1e-12
    # perturbed
    noisy = poses.copy()
    noisy[:, :3, 3] += 0.01
    err2 = trajectory.ate_rmse(ts, poses, ts, noisy)
    assert err2 < 1e-6  # rigid offset is aligned away


def test_matrix_trajectory(tmp_path):
    poses = [np.eye(4)]
    out = tmp_path / "loc.txt"
    trajectory.save_matrix_trajectory(out, poses)
    vals = [float(v) for v in out.read_text().split()]
    assert len(vals) == 12
    np.testing.assert_allclose(vals[0], 1.0)
