"""Parity: the single-kernel Triton LM pose schedule (interpret mode on CPU)
must match the XLA reference implementation (`pose_opt._lm_rounds`) on the
same problem, and the selector must route GPU backends to the kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam_mapsave_tpu.geometry import projection, se3
from orbslam_mapsave_tpu.optim import pose_opt, pose_opt_pallas


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    M = 2048  # the tracker's max_keypoints at the reference operating point
    cam = projection.Camera.create(520.0, 520.0, 320.0, 240.0, bf=41.6,
                                   width=640, height=480)
    pts = rng.uniform([-2, -2, 1.5], [2, 2, 6], (M, 3)).astype(np.float32)
    xi = np.array([0.04, -0.02, 0.03, 0.012, -0.018, 0.01], np.float32)
    T_true = np.asarray(se3.se3_exp(jnp.asarray(xi)))
    p_cam = pts @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([520 * p_cam[:, 0] / p_cam[:, 2] + 320,
                   520 * p_cam[:, 1] / p_cam[:, 2] + 240], -1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    out = rng.random(M) < 0.1
    uv[out] += rng.uniform(20, 60, (out.sum(), 2)).astype(np.float32)
    ur = np.full(M, -1.0, np.float32)
    st = rng.random(M) < 0.3
    ur[st] = (uv[st, 0] - 41.6 / p_cam[st, 2]).astype(np.float32)
    valid = rng.random(M) > 0.05
    obs = pose_opt.PoseObs(
        pt_w=jnp.asarray(pts), uv=jnp.asarray(uv), ur=jnp.asarray(ur),
        inv_sigma2=jnp.ones(M, jnp.float32), valid=jnp.asarray(valid),
    )
    return cam, obs, T_true


def test_pallas_lm_matches_xla(problem):
    cam, obs, T_true = problem
    pose0 = jnp.eye(4, dtype=jnp.float32)
    p_ref, inl_ref, n_ref = pose_opt.pose_optimization_xla(cam, pose0, obs)
    p_pal, inl_pal, n_pal = pose_opt_pallas.pose_optimization_pallas(
        cam, pose0, obs, interpret=True)
    assert np.abs(np.asarray(p_ref) - np.asarray(p_pal)).max() < 1e-5
    assert int(n_ref) == int(n_pal)
    assert np.array_equal(np.asarray(inl_ref), np.asarray(inl_pal))
    # and both recover the true pose
    assert np.abs(np.asarray(p_pal) - T_true).max() < 5e-3


@pytest.mark.parametrize("cut", [1500, 900])
def test_pallas_lm_nonpow2_capacity(problem, cut):
    """Edge counts that aren't powers of two are padded with invalid edges."""
    cam, obs, _ = problem
    obs_c = pose_opt.PoseObs(*[x[:cut] for x in obs])
    pose0 = jnp.eye(4, dtype=jnp.float32)
    p_ref, inl_ref, n_ref = pose_opt.pose_optimization_xla(cam, pose0, obs_c)
    p_pal, inl_pal, n_pal = pose_opt_pallas.pose_optimization_pallas(
        cam, pose0, obs_c, interpret=True)
    assert inl_pal.shape == (cut,)
    assert np.abs(np.asarray(p_ref) - np.asarray(p_pal)).max() < 1e-5
    assert int(n_ref) == int(n_pal)
    assert np.array_equal(np.asarray(inl_ref), np.asarray(inl_pal))


def test_padded_edges():
    assert pose_opt_pallas.padded_edges(2048) == 2048
    assert pose_opt_pallas.padded_edges(1500) == 2048
    assert pose_opt_pallas.padded_edges(2049) == 4096
    assert pose_opt_pallas.padded_edges(5) == 128


@pytest.mark.parametrize("backend,kernel", [("gpu", True), ("cpu", False)])
def test_selector_routes_by_backend(problem, monkeypatch, backend, kernel):
    cam, obs, _ = problem
    calls = []

    def fake_kernel(cam, pose0, obs):
        calls.append("kernel")
        return pose0, obs.valid, jnp.sum(obs.valid.astype(jnp.int32))

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(pose_opt_pallas, "pose_optimization_pallas",
                        fake_kernel)
    assert pose_opt._use_pallas() is kernel
    # trace the dispatcher without its jit cache, so the selector runs
    jax.make_jaxpr(pose_opt.pose_optimization.__wrapped__)(
        cam, jnp.eye(4, dtype=jnp.float32), obs)
    assert calls == (["kernel"] if kernel else [])


@pytest.mark.gpu
def test_pallas_lm_compiled_matches_xla(problem, gpu):
    """The kernel as Triton compiles it for the card (chip_smoke.py phase 4
    runs the same comparison): pose within 1e-4, at most 0.5% of edges
    classified differently (block reductions sum in another order)."""
    cam, obs, _ = problem
    pose0 = jnp.eye(4, dtype=jnp.float32)
    p_ref, inl_ref, _ = pose_opt.pose_optimization_xla(cam, pose0, obs)
    p_pal, inl_pal, _ = pose_opt_pallas.pose_optimization_pallas(
        cam, pose0, obs)
    assert np.abs(np.asarray(p_ref) - np.asarray(p_pal)).max() < 1e-4
    assert (np.asarray(inl_ref) != np.asarray(inl_pal)).sum() <= 0.005 * len(
        inl_ref)
