"""Motion-only pose optimization (the per-frame hot optimizer).

`Optimizer::PoseOptimization` parity (`src/Optimizer.cc:239-451`): optimize a
single frame pose Tcw against fixed 3D map points.

Reference behavior carried over exactly:
- 4 rounds x 10 LM iterations (`src/Optimizer.cc:369-379`);
- Huber delta sqrt(5.991) mono / sqrt(7.815) stereo, applied during the
  first two rounds only (round >= 2 drops the robust kernel, matching
  `e->setRobustKernel(0)` at `src/Optimizer.cc:434-437` [reference does this
  at it==2 via nullifying kernels for inlier edges]);
- after each round, edges re-classified: chi2 > 5.991 (mono) / 7.815
  (stereo) -> outlier, excluded from the next round but re-tested every
  round (outliers can come back, `src/Optimizer.cc:396-430`);
- per-octave information invSigma2 = 1/1.5^(2*octave)
  (`Frame::mvInvLevelSigma2`, set from the scale pyramid);
- returns (pose, inlier mask, n_inliers) — caller requires >= 10 matches
  like the reference (`src/Optimizer.cc:292` nInitialCorrespondences<3 check
  and Tracking's >= 10 gates).

Design: all M candidate edges (padded, masked) are processed as one batch;
the 6x6 normal system is formed by one einsum reduction and solved in closed
form — no graph construction, no sparse structures. On a GPU the whole
schedule runs as one Pallas (Triton) kernel (`pose_opt_pallas.py`); this
module's XLA schedule is its reference and the path everywhere else.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import projection, se3
from . import lm


def _use_pallas() -> bool:
    """The single-kernel LM schedule (pose_opt_pallas.py) replaces the XLA
    chain on GPU; every other backend (CPU tests, virtual meshes) keeps the
    XLA path."""
    return jax.default_backend() == "gpu"


class PoseObs(NamedTuple):
    """Fixed-capacity match set for one frame."""

    pt_w: jax.Array  # (M,3) world points
    uv: jax.Array  # (M,2) observed undistorted pixels
    ur: jax.Array  # (M,) observed right-u; < 0 -> mono edge
    inv_sigma2: jax.Array  # (M,) per-octave information
    valid: jax.Array  # (M,) candidate mask


def _residuals(cam: projection.Camera, pose_cw: jax.Array, obs: PoseObs):
    """Residuals + chi2 per edge. Stereo edges get a 3rd (uR) component."""
    p_cam = se3.transform_points(pose_cw, obs.pt_w)
    uv_hat, z = projection.project(cam, p_cam)
    zsafe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    ur_hat = uv_hat[..., 0] - cam.bf / zsafe
    is_stereo = obs.ur >= 0
    e_uv = obs.uv - uv_hat  # (M,2)
    e_ur = jnp.where(is_stereo, obs.ur - ur_hat, 0.0)  # (M,)
    chi2 = (jnp.sum(e_uv * e_uv, -1) + e_ur * e_ur) * obs.inv_sigma2
    behind = z <= 0
    return p_cam, e_uv, e_ur, chi2, is_stereo, behind


def _normal_system(cam: projection.Camera, pose_cw: jax.Array, obs: PoseObs,
                   active: jax.Array, robust: jax.Array):
    """Accumulate H (6,6), g (6,) over active edges with optional Huber."""
    p_cam, e_uv, e_ur, chi2, is_stereo, behind = _residuals(cam, pose_cw, obs)
    active_in = active
    active = active & ~behind
    delta2 = jnp.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO)
    w_rob = jnp.where(robust, lm.huber_weight(chi2, delta2), 1.0)
    w = obs.inv_sigma2 * w_rob * active.astype(pose_cw.dtype)

    J_proj = lm.proj_jacobian(p_cam, cam.fx, cam.fy)  # (M,2,3)
    J_pt = lm.point_pose_jacobian(p_cam)  # (M,3,6)
    J_uv = -jnp.einsum("mij,mjk->mik", J_proj, J_pt, precision=lm.HI)  # (M,2,6)
    # uR row: d(uR)/dP = d(u)/dP + bf/z^2 * dz/dP = J_proj[0] + [0,0,bf/z^2]
    z = p_cam[..., 2]
    zi2 = 1.0 / jnp.square(jnp.where(jnp.abs(z) < 1e-9, 1e-9, z))
    dur_dp = J_proj[:, 0, :] + jnp.stack(
        [jnp.zeros_like(z), jnp.zeros_like(z), cam.bf * zi2], axis=-1
    )
    J_ur = -jnp.einsum("mj,mjk->mk", dur_dp, J_pt, precision=lm.HI)  # (M,6)
    J_ur = jnp.where(is_stereo[:, None], J_ur, 0.0)

    # H = sum_m w_m (J_uv^T J_uv + J_ur J_ur^T); g = -J^T e  (e defined obs-hat,
    # so the Gauss-Newton step solves H dx = J^T e with our sign: g = J_uv^T e)
    Hm = jnp.einsum("mia,mib->mab", J_uv, J_uv, precision=lm.HI) + jnp.einsum(
        "ma,mb->mab", J_ur, J_ur, precision=lm.HI
    )
    gm = jnp.einsum("mia,mi->ma", J_uv, e_uv, precision=lm.HI) + J_ur * e_ur[:, None]
    H = jnp.einsum("mab,m->ab", Hm, w, precision=lm.HI)
    g = -jnp.einsum("ma,m->a", gm, w, precision=lm.HI)
    # acceptance cost: edges pushed behind the camera pay a fixed penalty
    # instead of dropping out of the sum (masking them would make divergent
    # steps look like improvements — see local_ba._accept_cost)
    val = jnp.where(behind, 1e7, chi2 * w_rob)
    val = jnp.where(jnp.isfinite(val), val, 1e7)
    total_chi2 = jnp.sum(jnp.where(active_in, val, 0.0))
    return H, g, total_chi2


def _lm_rounds(cam, pose0, obs, n_rounds=4, n_iters=10):
    """The reference's 4x10 schedule with inter-round outlier reclassification."""
    dtype = pose0.dtype
    pose = pose0
    inlier = obs.valid

    for rnd in range(n_rounds):
        robust = jnp.asarray(rnd < 2)  # kernels dropped from round 2 (it==2)

        def iter_body(carry, _):
            pose, lam = carry
            H, g, chi2 = _normal_system(cam, pose, obs, inlier, robust)
            dx = lm.solve_spd(H, g, lam)
            new_pose = se3.se3_exp(dx) @ pose
            _, _, new_chi2 = _normal_system(cam, new_pose, obs, inlier, robust)
            accept = new_chi2 < chi2
            pose = jnp.where(accept, new_pose, pose)
            lam = jnp.where(accept, lam * 0.5, lam * 4.0)
            lam = jnp.clip(lam, 1e-10, 1e6)
            return (pose, lam), None

        (pose, _), _ = jax.lax.scan(
            iter_body, (pose, jnp.asarray(1e-4, dtype)), None, length=n_iters
        )
        # reclassify against raw chi2 (no robust weight), Optimizer.cc:396-430
        _, _, _, chi2, is_stereo, behind = _residuals(cam, pose, obs)
        chi2 = chi2  # already includes invSigma2
        gate = jnp.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO)
        inlier = obs.valid & (chi2 <= gate) & ~behind
    return pose, inlier


@jax.jit
def pose_optimization_xla(cam: projection.Camera, pose0_cw: jax.Array,
                          obs: PoseObs):
    """The pure-XLA schedule: the kernel's reference, and the vmap-safe
    variant (the kernel is one program per call; the batched relocalizer
    maps over candidates with this one)."""
    pose, inlier = _lm_rounds(cam, pose0_cw, obs)
    # ~40 f32 exp()@pose products leave the rotation slightly off SO(3);
    # uncorrected, the tracker's velocity feedback amplifies that error
    # geometrically (see se3.orthonormalize). Project back every call.
    pose = se3.orthonormalize(pose)
    return pose, inlier, jnp.sum(inlier.astype(jnp.int32))


@partial(jax.jit, static_argnums=())
def pose_optimization(cam: projection.Camera, pose0_cw: jax.Array,
                      obs: PoseObs):
    """Run the full schedule; returns (pose_cw, inlier_mask, n_inliers)."""
    if _use_pallas():
        from . import pose_opt_pallas

        return pose_opt_pallas.pose_optimization_pallas(cam, pose0_cw, obs)
    return pose_optimization_xla(cam, pose0_cw, obs)
