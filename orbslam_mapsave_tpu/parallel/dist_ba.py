"""Distributed bundle adjustment over a jax.sharding.Mesh.

The reference has NO distributed anything (SURVEY.md §2.4) — this is the
scaling layer demanded by BASELINE.json: keyframes/landmarks
partitioned over devices, Schur-complement reduction of the camera system
over collectives, batched LM solve on device (§5.7/§5.8).

Design (scaling-book recipe: pick a mesh, annotate shardings, let XLA insert
collectives):
- mesh axis "pt": LANDMARKS are sharded — each device owns L/n points and
  their observation rows (the heavy per-edge Jacobian work);
- the reduced camera system S = Hcc - W Hpp^-1 W^T is a SUM over landmarks,
  so each device reduces its shard locally and one `psum` over "pt"
  produces the replicated (C*6, C*6) system — this is the all-reduce of the
  reduced camera Hessian from SURVEY.md §5.7;
- the dense solve is replicated (tiny); landmark back-substitution is local
  to each shard — no further communication.

Per-iteration comm = one psum of (C*6)^2 + C*6 floats, independent of L:
the textbook compute/communication split for sparse-BA on SPMD hardware.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import projection, se3
from ..optim import lm as lm_mod
from ..optim.local_ba import BAProblem, BAResult, _edge_terms, _robust_chi2


def shard_problem(prob: BAProblem, mesh: Mesh, axis: str = "pt") -> BAProblem:
    """Place landmark-major arrays sharded over `axis`, camera arrays
    replicated."""
    pt_sharded = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def put(x, sh):
        return jax.device_put(x, sh)

    return BAProblem(
        cam_pose=put(prob.cam_pose, rep),
        cam_fixed=put(prob.cam_fixed, rep),
        cam_valid=put(prob.cam_valid, rep),
        pt_pos=put(prob.pt_pos, pt_sharded),
        pt_valid=put(prob.pt_valid, pt_sharded),
        obs_cam=put(prob.obs_cam, pt_sharded),
        obs_uv=put(prob.obs_uv, pt_sharded),
        obs_ur=put(prob.obs_ur, pt_sharded),
        obs_inv_sigma2=put(prob.obs_inv_sigma2, pt_sharded),
        obs_valid=put(prob.obs_valid, pt_sharded),
    )


def _local_reduced_system(cam, poses, pts, prob: BAProblem, active, robust,
                          lam):
    """Per-shard: landmark blocks + local contribution to the reduced camera
    system. Runs inside shard_map; returns (S_local, rhs_local, Hpp_inv, gp, W)."""
    C = prob.cam_pose.shape[0]
    L, O = prob.obs_cam.shape
    r, Jc, Jp, chi2, ok, is_st = _edge_terms(cam, poses, pts, prob)
    ok = ok & active
    delta2 = jnp.where(is_st, lm_mod.CHI2_STEREO, lm_mod.CHI2_MONO)
    w_rob = jnp.where(robust, lm_mod.huber_weight(chi2, delta2), 1.0)
    w = jnp.where(ok, prob.obs_inv_sigma2 * w_rob, 0.0)
    free = prob.cam_valid & ~prob.cam_fixed
    Jc = jnp.where(free[jnp.clip(prob.obs_cam, 0)][..., None, None], Jc, 0.0)

    Hpp = jnp.einsum("loia,lo,loib->lab", Jp, w, Jp, precision=lm_mod.HI)
    gp = -jnp.einsum("loia,lo,loi->la", Jp, w, r, precision=lm_mod.HI)
    Hcc_e = jnp.einsum("loia,lo,loib->loab", Jc, w, Jc, precision=lm_mod.HI)
    gc_e = -jnp.einsum("loia,lo,loi->loa", Jc, w, r, precision=lm_mod.HI)
    W = jnp.einsum("loia,lo,loib->loab", Jc, w, Jp, precision=lm_mod.HI)

    eye3 = jnp.eye(3, dtype=pts.dtype)
    pt_has = jnp.sum(w, -1) > 0
    Hpp_inv = jnp.linalg.inv(
        jnp.where(pt_has[:, None, None], Hpp + lam * eye3[None], eye3[None])
    )
    safe_cam = jnp.clip(prob.obs_cam, 0)
    Hcc = jnp.zeros((C, 6, 6), pts.dtype).at[safe_cam.reshape(-1)].add(
        Hcc_e.reshape(L * O, 6, 6)
    )
    gc = jnp.zeros((C, 6), pts.dtype).at[safe_cam.reshape(-1)].add(
        gc_e.reshape(L * O, 6)
    )
    WHinv = jnp.einsum("loab,lbc->loac", W, Hpp_inv, precision=lm_mod.HI)
    pair = jnp.einsum("loac,lpbc->lopab", WHinv, W, precision=lm_mod.HI)
    rhs_corr = jnp.einsum("loab,lb->loa", WHinv, gp, precision=lm_mod.HI)
    S = jnp.zeros((C, C, 6, 6), pts.dtype)
    ci = jnp.broadcast_to(safe_cam[:, :, None], (L, O, O))
    cj = jnp.broadcast_to(safe_cam[:, None, :], (L, O, O))
    S = S.at[ci.reshape(-1), cj.reshape(-1)].add(-pair.reshape(-1, 6, 6))
    S = S.at[jnp.arange(C), jnp.arange(C)].add(Hcc)
    rhs = gc - jnp.zeros((C, 6), pts.dtype).at[safe_cam.reshape(-1)].add(
        rhs_corr.reshape(L * O, 6)
    )
    return S, rhs, Hpp_inv, gp, W, pt_has, ok


def make_distributed_ba(cam: projection.Camera, mesh: Mesh, axis: str = "pt",
                        n_iters: int = 10):
    """Build a pjit-compiled distributed BA step over `mesh`.

    Input BAProblem must be sharded with `shard_problem`. The returned
    function runs `n_iters` damped LM iterations; each iteration does the
    per-shard reduction + ONE psum of the reduced camera system.
    """
    from jax import shard_map

    pt_spec = P(axis)
    rep = P()

    def one_iteration(poses, pts, prob, active, lam):
        robust = jnp.asarray(True)

        def shard_fn(poses, pts, cam_pose, cam_fixed, cam_valid, pt_valid,
                     obs_cam, obs_uv, obs_ur, obs_is2, obs_ok, act):
            local_prob = BAProblem(cam_pose, cam_fixed, cam_valid, pts,
                                   pt_valid, obs_cam, obs_uv, obs_ur,
                                   obs_is2, obs_ok)
            S, rhs, Hpp_inv, gp, W, pt_has, ok = _local_reduced_system(
                cam, poses, pts, local_prob, act, robust, lam
            )
            # all-reduce the camera system over the landmark shards (ICI)
            S = jax.lax.psum(S, axis)
            rhs = jax.lax.psum(rhs, axis)
            C = S.shape[0]
            free = cam_valid & ~cam_fixed
            Sf = S.transpose(0, 2, 1, 3).reshape(C * 6, C * 6)
            mask = jnp.repeat(free, 6)
            Sf = jnp.where(mask[:, None] & mask[None, :], Sf, 0.0)
            Sf = Sf + jnp.diag(jnp.where(mask, lam, 1.0))
            rhs_f = jnp.where(mask, rhs.reshape(-1), 0.0)
            dx_cam = jnp.linalg.solve(Sf, rhs_f).reshape(C, 6)
            dx_cam = jnp.where(jnp.isfinite(dx_cam), dx_cam, 0.0)
            # local landmark back-substitution
            safe_cam = jnp.clip(obs_cam, 0)
            Wt_dx = jnp.einsum("loab,loa->lb", W,
                               dx_cam[safe_cam] * ok[..., None],
                               precision=lm_mod.HI)
            dx_pt = jnp.einsum("lab,lb->la", Hpp_inv, gp - Wt_dx,
                               precision=lm_mod.HI)
            dx_pt = jnp.where((pt_has & pt_valid)[:, None], dx_pt, 0.0)
            dx_pt = jnp.where(jnp.isfinite(dx_pt), dx_pt, 0.0)
            return dx_cam, dx_pt

        dx_cam, dx_pt = shard_map(
            shard_fn, mesh=mesh,
            in_specs=(rep, pt_spec, rep, rep, rep, pt_spec, pt_spec, pt_spec,
                      pt_spec, pt_spec, pt_spec, pt_spec),
            out_specs=(rep, pt_spec),
            check_vma=False,
        )(poses, pts, prob.cam_pose, prob.cam_fixed, prob.cam_valid,
          prob.pt_valid, prob.obs_cam, prob.obs_uv, prob.obs_ur,
          prob.obs_inv_sigma2, prob.obs_valid, active)
        free = (prob.cam_valid & ~prob.cam_fixed)[:, None]
        new_poses = se3.se3_exp(jnp.where(free, dx_cam, 0.0)) @ poses
        new_pts = pts + dx_pt
        return new_poses, new_pts

    @jax.jit
    def run(prob: BAProblem):
        poses = prob.cam_pose
        pts = prob.pt_pos
        active = prob.obs_valid
        lam = jnp.asarray(1e-4, pts.dtype)

        def body(carry, _):
            poses, pts, lam = carry
            _, _, _, chi2_e, ok, is_st = _edge_terms(cam, poses, pts, prob)
            cur = _robust_chi2(chi2_e, is_st, ok & active, jnp.asarray(True))
            new_poses, new_pts = one_iteration(poses, pts, prob, active, lam)
            _, _, _, chi2_n, ok_n, is_n = _edge_terms(cam, new_poses, new_pts, prob)
            new = _robust_chi2(chi2_n, is_n, ok_n & active, jnp.asarray(True))
            accept = new < cur
            poses = jnp.where(accept, new_poses, poses)
            pts = jnp.where(accept, new_pts, pts)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e8)
            return (poses, pts, lam), new

        (poses, pts, _), _ = jax.lax.scan(body, (poses, pts, lam), None,
                                          length=n_iters)
        _, _, _, chi2, ok, is_st = _edge_terms(cam, poses, pts, prob)
        inlier = prob.obs_valid & ok & (
            chi2 <= jnp.where(is_st, lm_mod.CHI2_STEREO, lm_mod.CHI2_MONO)
        )
        total = _robust_chi2(chi2, is_st, inlier, jnp.asarray(False))
        return BAResult(cam_pose=poses, pt_pos=pts, obs_inlier=inlier,
                        chi2=total)

    return run
