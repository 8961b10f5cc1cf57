"""Pose backbone: trains on the synthetic skeleton renderer and drives
the full OpDetector chain (backbone -> Kalman -> 3D lift -> mask), the
pipeline of `/root/reference/src/DetectHumanPose.cpp`."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from orbslam_mapsave_tpu.apps.human_pose import OpDetector
from orbslam_mapsave_tpu.models import pose_net, pose_synth


@pytest.fixture(scope="module")
def trained():
    return pose_net.train_on_synthetic(height=96, width=96, steps=220,
                                       batch=16, net_width=32, seed=0)


def test_training_localizes_joints(trained):
    net, params = trained
    rng = np.random.default_rng(123)
    imgs, joints = pose_synth.render_batch(rng, 8, 96, 96)
    errs = []
    for i in range(8):
        kp = np.asarray(pose_net._infer(net, params, imgs[i]))
        errs.append(np.linalg.norm(kp[:, :2] - joints[i], axis=-1))
    mean_err = float(np.mean(errs))
    # untrained soft-argmax sits at the image center (~30 px off); trained
    # must localize to within a few heatmap cells
    assert mean_err < 8.0, mean_err


def test_backbone_drives_opdetector(trained):
    net, params = trained
    det = OpDetector(backbone=pose_net.make_backbone(net, params),
                     fx=100.0, fy=100.0, cx=48.0, cy=48.0, mask_radius=8)
    assert det.available
    rng = np.random.default_rng(7)
    img, joints = pose_synth.render_stick_figure(rng, 96, 96)
    depth = np.full((96, 96), 2.0, np.float32)
    mask = None
    for _ in range(3):  # let the Kalman filters settle
        mask = det.run_frame(img, depth)
    assert mask is not None
    # 3D lift: hip joint should sit near depth 2 m
    assert abs(det.joints_3d[8, 2] - 2.0) < 0.3
    # mask (0 = human) covers the smoothed hip pixel
    hy, hx = int(det.joints_2d[8, 1]), int(det.joints_2d[8, 0])
    assert mask[hy, hx] == 0.0
    assert det.gait_angles()["r_knee"] >= 0.0
