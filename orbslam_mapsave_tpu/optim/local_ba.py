"""Batched Levenberg-Marquardt bundle adjustment with explicit Schur complement.

Vectorized rebuild of g2o's sparse BA stack (`BlockSolver_6_3` +
`OptimizationAlgorithmLevenberg`, `Thirdparty/g2o/g2o/core/block_solver.hpp`)
as used by `Optimizer::LocalBundleAdjustment` (`src/Optimizer.cc:453-779`) and
`Optimizer::BundleAdjustment` (`src/Optimizer.cc:49-237`):

- the solve runs directly on the point-major (L points x O lanes)
  observation table: padded lanes carry zero weight, so their over-compute
  is free vector work — while every index-based alternative (edge
  compaction + scatter-add) serializes on scatters;
- landmark blocks Hpp are 3x3 lane-local sums -> inverted in closed form
  (adjugate), batched over all points at once;
- ALL camera-side reductions are one-hot matmuls against the
  (L,O,C) one-hot of obs_cam (computed once per solve);
- the reduced camera system S = Hcc - W Hpp^-1 W^T is assembled DENSELY via
  per-point camera stacks T[l,c,6,3] = OH^T W — covisible windows are small
  (<= ~100 cams, SURVEY.md §7.3) so the dense system suits matmul units;
- Huber IRLS with the reference's deltas sqrt(5.991)/sqrt(7.815)
  (`src/Optimizer.cc:522-523,555,584`);
- fixed cameras (the observers outside the window, `src/Optimizer.cc:489-504`)
  enter residuals but get identity rows in the solve;
- the 5-then-10 iteration schedule with inter-phase outlier pruning and an
  abort flag checked between phases mirrors `src/Optimizer.cc:660-717` and
  g2o's `forceStopFlag` semantics.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import projection, se3
from . import lm


class BAProblem(NamedTuple):
    cam_pose: jax.Array  # (C,4,4) initial Tcw
    cam_fixed: jax.Array  # (C,) bool — pose held constant
    cam_valid: jax.Array  # (C,) bool
    pt_pos: jax.Array  # (L,3) initial world positions
    pt_valid: jax.Array  # (L,) bool
    obs_cam: jax.Array  # (L,O) i32 camera index or -1
    obs_uv: jax.Array  # (L,O,2) undistorted pixels
    obs_ur: jax.Array  # (L,O) right-u, <0 mono
    obs_inv_sigma2: jax.Array  # (L,O)
    obs_valid: jax.Array  # (L,O) bool


class BAResult(NamedTuple):
    cam_pose: jax.Array  # (C,4,4)
    pt_pos: jax.Array  # (L,3)
    obs_inlier: jax.Array  # (L,O) bool — final classification
    chi2: jax.Array  # () total robust chi2


def _onehot_cam(prob: BAProblem) -> jax.Array:
    """(L,O,C) f32 one-hot of obs_cam — the dense reduction operator.

    Constant across LM iterations (depends only on the problem structure),
    so callers compute it once and thread it through the solve. Every
    camera-side reduction AND every camera->lane broadcast becomes a matmul
    against this operator (at HIGHEST precision, exact for 0/1 operands)
    instead of a scatter/gather: scatters serialize, while a dense
    contraction does the same reduction in parallel.
    """
    C = prob.cam_pose.shape[0]
    oh = (prob.obs_cam[..., None] == jnp.arange(C, dtype=jnp.int32)) & (
        prob.obs_cam >= 0
    )[..., None]
    return oh.astype(prob.pt_pos.dtype)


_inv3x3 = lm.inv3x3


def _edge_terms_po(cam: projection.Camera, poses: jax.Array, pts: jax.Array,
                   prob: BAProblem, oh: jax.Array):
    """Residuals/Jacobians per (L,O) observation lane — the point-major
    twin of `_edge_terms` that keeps structural validity and cheirality
    separate (the LM acceptance cost needs them apart).

    Returns r (L,O,3), Jc (L,O,3,6), Jp (L,O,3,3), chi2 (L,O),
    ok_struct (L,O), ok_z (L,O), is_st (L,O). Third residual row is the
    stereo uR term (zeroed for mono edges) — g2o's
    `EdgeStereoSE3ProjectXYZ` (`types_six_dof_expmap.h:130-174`).

    NOTE on contraction style throughout this module: einsums whose
    contraction axis is tiny (2-3 wide) over a huge (L,O) batch lower to
    batched-matmul "convolution fusions"; the same contraction written as
    broadcast multiply + sum fuses into one element-wise pass. Real matmuls (contraction over C or L) stay einsums — this
    also covers broadcasting poses to lanes: `poses[obs_cam]` is a
    row gather, `einsum(loc,cjk->lojk)` the equivalent matmul.
    """
    ok_struct = prob.obs_valid & (prob.obs_cam >= 0) & prob.pt_valid[:, None]
    R = jnp.einsum("loc,cjk->lojk", oh, poses[:, :3, :3], precision=lm.HI)
    t = jnp.einsum("loc,cj->loj", oh, poses[:, :3, 3], precision=lm.HI)
    p_cam = jnp.sum(R * pts[:, None, None, :], axis=-1) + t
    z = p_cam[..., 2]
    ok_z = z > 1e-6
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * p_cam[..., 0] / zs + cam.cx
    v = cam.fy * p_cam[..., 1] / zs + cam.cy
    ur = u - cam.bf / zs
    is_st = prob.obs_ur >= 0
    r = jnp.stack(
        [
            prob.obs_uv[..., 0] - u,
            prob.obs_uv[..., 1] - v,
            jnp.where(is_st, prob.obs_ur - ur, 0.0),
        ],
        axis=-1,
    )  # (L,O,3)
    J_proj = lm.proj_jacobian(p_cam, cam.fx, cam.fy)  # (L,O,2,3)
    zi2 = 1.0 / (zs * zs)
    dur_dp = J_proj[..., 0, :] + jnp.stack(
        [jnp.zeros_like(z), jnp.zeros_like(z), cam.bf * zi2], axis=-1
    )
    dur_dp = jnp.where(is_st[..., None], dur_dp, 0.0)
    A = jnp.concatenate([J_proj, dur_dp[..., None, :]], axis=-2)  # (L,O,3,3)
    Jc_pt = lm.point_pose_jacobian(p_cam)  # (L,O,3,6)
    Jc = -jnp.sum(A[..., :, :, None] * Jc_pt[..., None, :, :], axis=-2)
    Jp = -jnp.sum(A[..., :, :, None] * R[..., None, :, :], axis=-2)
    chi2 = jnp.sum(r * r, -1) * prob.obs_inv_sigma2
    return r, Jc, Jp, chi2, ok_struct, ok_z, is_st


# Cost charged to an edge the candidate step pushed behind the camera
# (z <= 0). g2o keeps such edges in the chi2 sum with their (huge) flipped
# -projection residuals; masking them out instead would make a divergent
# step look like an improvement (fewer summed edges), so LM would accept
# NaN/garbage poses. A large constant preserves the reject-bad-steps
# property with static shapes.
_BEHIND_PENALTY = 1e7


# ---------------------------------------------------------------------------
# Point-major residual helpers kept for the distributed BA path
# (`parallel/dist_ba.py`), where the (L,O) lane layout shards over the point
# axis without compaction.
# ---------------------------------------------------------------------------


def _edge_terms(cam: projection.Camera, poses: jax.Array, pts: jax.Array,
                prob: BAProblem):
    """Per-lane residuals/Jacobians over the padded (L,O) table.

    Returns r (L,O,3), Jc (L,O,3,6), Jp (L,O,3,3), chi2 (L,O), active, is_st.
    """
    ok = prob.obs_valid & (prob.obs_cam >= 0) & prob.pt_valid[:, None]
    safe_cam = jnp.clip(prob.obs_cam, 0)
    T = poses[safe_cam]  # (L,O,4,4)
    R = T[..., :3, :3]
    p_cam = jnp.einsum("loij,lj->loi", R, pts) + T[..., :3, 3]
    z = p_cam[..., 2]
    ok = ok & (z > 1e-6)
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * p_cam[..., 0] / zs + cam.cx
    v = cam.fy * p_cam[..., 1] / zs + cam.cy
    ur = u - cam.bf / zs
    is_st = prob.obs_ur >= 0
    r = jnp.stack(
        [
            prob.obs_uv[..., 0] - u,
            prob.obs_uv[..., 1] - v,
            jnp.where(is_st, prob.obs_ur - ur, 0.0),
        ],
        axis=-1,
    )
    J_proj = lm.proj_jacobian(p_cam, cam.fx, cam.fy)
    zi2 = 1.0 / (zs * zs)
    dur_dp = J_proj[..., 0, :] + jnp.stack(
        [jnp.zeros_like(z), jnp.zeros_like(z), cam.bf * zi2], axis=-1
    )
    dur_dp = jnp.where(is_st[..., None], dur_dp, 0.0)
    A = jnp.concatenate([J_proj, dur_dp[..., None, :]], axis=-2)
    Jc_pt = lm.point_pose_jacobian(p_cam)
    Jc = -jnp.einsum("loij,lojk->loik", A, Jc_pt)
    Jp = -jnp.einsum("loij,lojk->loik", A, R)
    chi2 = jnp.sum(r * r, -1) * prob.obs_inv_sigma2
    return r, Jc, Jp, chi2, ok, is_st


def _robust_chi2(chi2, is_st, ok, robust):
    delta2 = jnp.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO)
    d = jnp.sqrt(delta2)
    rho = jnp.where(chi2 <= delta2, chi2,
                    2.0 * d * jnp.sqrt(jnp.maximum(chi2, 0)) - delta2)
    val = jnp.where(robust, rho, chi2)
    return jnp.sum(jnp.where(ok, val, 0.0))


def _accept_cost_po(chi2, is_st, ok_z, active, robust):
    """LM acceptance objective: Huber chi2 over active lanes, with invalid
    projections (behind camera) paying a fixed penalty."""
    delta2 = jnp.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO)
    d = jnp.sqrt(delta2)
    rho = jnp.where(chi2 <= delta2, chi2,
                    2.0 * d * jnp.sqrt(jnp.maximum(chi2, 0)) - delta2)
    val = jnp.where(robust, rho, chi2)
    val = jnp.where(ok_z, val, _BEHIND_PENALTY)
    val = jnp.where(jnp.isfinite(val), val, _BEHIND_PENALTY)
    return jnp.sum(jnp.where(active, val, 0.0))


def _cost_at(cam, poses, pts, prob, oh, active, robust):
    _, _, _, chi2, _, ok_z, is_st = _edge_terms_po(cam, poses, pts, prob, oh)
    return _accept_cost_po(chi2, is_st, ok_z, active, robust)


def _build_and_solve(cam, poses, pts, prob, oh, active, robust, lam):
    """One damped LM step in the point-major layout. Returns
    (dx_cam (C,6), dx_pt (L,3)).

    Scatter-free Schur assembly: with OH the (L,O,C) one-hot of obs_cam,

        Hcc      = einsum(loc, lo(ab)   -> c(ab))   [camera diagonal]
        T1[l,c]  = einsum(loc, lo(ak)   -> lc(ak))  [per-point cam stack]
        S        = Hcc_diag - einsum(lcak, ldbk -> cadb)

    replaces the former (C,L,6,3) scatter-adds, which serialized ~E rows per
    LM iteration. All padded lanes carry zero weight, so the 8x lane
    over-compute is parallel work instead of serialized scatter traffic.
    """
    C = prob.cam_pose.shape[0]
    r, Jc, Jp, chi2, ok_s, ok_z, is_st = _edge_terms_po(cam, poses, pts, prob, oh)
    ok = active & ok_s & ok_z
    delta2 = jnp.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO)
    w_rob = jnp.where(robust, lm.huber_weight(chi2, delta2), 1.0)
    w = jnp.where(ok, prob.obs_inv_sigma2 * w_rob, 0.0)  # (L,O)

    free = prob.cam_valid & ~prob.cam_fixed  # (C,)
    # zero Jc for fixed cameras so they contribute no derivatives
    free_lane = jnp.einsum("loc,c->lo", oh, free.astype(oh.dtype)) > 0.5
    Jc = jnp.where(free_lane[..., None, None], Jc, 0.0)

    # --- per-lane blocks (weighted); tiny contractions as multiply+sum ---
    wJp = Jp * w[..., None, None]
    wJc = Jc * w[..., None, None]
    Hpp = jnp.sum(wJp[..., :, :, None] * Jp[..., :, None, :],
                  axis=(1, 2))  # (L,3,3) lane-local sum
    gp = -jnp.sum(wJp * r[..., None], axis=(1, 2))  # (L,3)
    Hcc_lo = jnp.sum(wJc[..., :, :, None] * Jc[..., :, None, :],
                     axis=-3)  # (L,O,6,6)
    gc_lo = -jnp.sum(wJc * r[..., None], axis=-2)  # (L,O,6)
    W_lo = jnp.sum(wJc[..., :, :, None] * Jp[..., :, None, :],
                   axis=-3)  # (L,O,6,3)

    pt_w = jnp.sum(w, axis=-1)  # (L,)
    pt_has_obs = pt_w > 0

    # damp landmark blocks, invert in closed form (batched 3x3).
    # Marquardt scaling (lam * diag(H)) keeps lam dimensionless: absolute
    # lam*I damping is negligible against fx^2-scale Hessian entries and
    # lets steps run away along the mono scale-gauge nullspace.
    eye3 = jnp.eye(3, dtype=pts.dtype)
    Hpp_diag = jnp.diagonal(Hpp, axis1=-2, axis2=-1)
    Hpp_d = Hpp + eye3 * (lam * Hpp_diag + 1e-8)[..., None]
    Hpp_inv = _inv3x3(jnp.where(pt_has_obs[:, None, None], Hpp_d, eye3[None]))

    # --- camera-side reductions: one-hot matmuls ---
    L, O = w.shape
    cam_flat = jnp.concatenate(
        [Hcc_lo.reshape(L, O, 36), gc_lo], axis=-1
    )  # (L,O,42)
    red = jnp.einsum("loc,loz->cz", oh, cam_flat, precision=lm.HI)
    Hcc = red[:, :36].reshape(C, 6, 6)
    gc = red[:, 36:42]

    WHinv_lo = jnp.sum(
        W_lo[..., :, :, None] * Hpp_inv[:, None, None, :, :], axis=-2
    )  # (L,O,6,3)
    rhs_corr_lo = jnp.sum(WHinv_lo * gp[:, None, None, :], axis=-1)  # (L,O,6)
    rhs_corr = jnp.einsum("loc,loa->ca", oh, rhs_corr_lo, precision=lm.HI)

    # --- Schur off-diagonal via dense per-point camera stacks ---
    T1 = jnp.einsum("loc,loak->lcak", oh, WHinv_lo, precision=lm.HI)
    T2 = jnp.einsum("loc,loak->lcak", oh, W_lo, precision=lm.HI)
    S = -jnp.einsum("lcak,ldbk->cadb", T1, T2, precision=lm.HI)  # (C,6,C,6)

    idx = jnp.arange(C)
    Hcc_diag = jnp.diagonal(Hcc, axis1=-2, axis2=-1)
    S = S.at[idx, :, idx, :].add(
        Hcc + jnp.eye(6, dtype=pts.dtype) * (lam * Hcc_diag + 1e-8)[..., None]
    )
    rhs = gc - rhs_corr

    # flatten to (6C,6C); fixed/invalid cams -> identity rows
    Sf = S.reshape(C * 6, C * 6)
    mask = jnp.repeat(free, 6)
    Sf = jnp.where(mask[:, None] & mask[None, :], Sf, 0.0)
    Sf = Sf + jnp.diag(jnp.where(mask, 0.0, 1.0))
    rhs_f = jnp.where(mask, rhs.reshape(-1), 0.0)
    # Cholesky: S is SPD by construction (damped Schur complement with
    # identity rows for fixed cams); `jnp.linalg.solve` lowers to
    # partial-pivot LU (see the same switch in optim/pose_graph.py)
    chol = jax.scipy.linalg.cho_factor(Sf, lower=True)
    dx_cam = jax.scipy.linalg.cho_solve(chol, rhs_f).reshape(C, 6)
    dx_cam = jnp.where(jnp.isfinite(dx_cam), dx_cam, 0.0)

    # back-substitute landmarks: dx_p = Hpp^-1 (gp - W^T dx_cam)
    dx_lane = jnp.einsum("loc,ca->loa", oh, dx_cam)  # (L,O,6)
    Wt_dx = jnp.sum(W_lo * dx_lane[..., :, None], axis=(1, 2))  # (L,3)
    dx_pt = jnp.sum(Hpp_inv * (gp - Wt_dx)[:, None, :], axis=-1)
    dx_pt = jnp.where((pt_has_obs & prob.pt_valid)[:, None], dx_pt, 0.0)
    dx_pt = jnp.where(jnp.isfinite(dx_pt), dx_pt, 0.0)
    return dx_cam, dx_pt


def _run_phase(cam, poses, pts, prob, oh, active, robust, n_iters, lam0,
               rtol: float = 1e-6):
    """Up to n_iters damped LM steps with EARLY TERMINATION: stop once two
    consecutive steps each improve the cost by < rtol*cost (rtol=1e-6:
    1e-5 measurably under-converged the bench map, kf ATE 0.0090 vs
    0.0082 at identical speed) (g2o's LM also
    terminates on negligible gain, `OptimizationAlgorithmLevenberg`; the
    reference's 5/10-iteration counts are CAPS, not mandates). On the warm
    windows local mapping feeds — only the newest keyframe and its fresh
    points are far from optimal — this cuts the typical iteration count
    severalfold, and each saved iteration is a full (L,O) lane pass +
    dense-Schur solve of device time."""
    free = (prob.cam_valid & ~prob.cam_fixed)[:, None]
    cur0 = _cost_at(cam, poses, pts, prob, oh, active, robust)

    def cond(carry):
        i, _, _, _, _, small = carry
        return (i < n_iters) & (small < 2)

    def body(carry):
        i, poses, pts, lam, cur, small = carry
        dxc, dxp = _build_and_solve(cam, poses, pts, prob, oh, active, robust,
                                    lam)
        new_poses = se3.se3_exp(jnp.where(free, dxc, 0.0)) @ poses
        new_pts = pts + dxp
        new = _cost_at(cam, new_poses, new_pts, prob, oh, active, robust)
        accept = new < cur
        # small-gain counting includes rejections: the windows local
        # mapping feeds are WARM (only the new keyframe + fresh points are
        # off-optimum), where near-converged steps oscillate between tiny
        # accepts and f32-noise rejections — requiring accepted steps would
        # run the full cap on every converged window.
        # The quality-critical full-map GBA uses the stricter accepted-only
        # rule instead (optim/global_ba.gba_iterate).
        gain_small = (cur - new) < rtol * cur
        small = jnp.where(gain_small, small + 1, 0)
        poses = jnp.where(accept, new_poses, poses)
        pts = jnp.where(accept, new_pts, pts)
        cur = jnp.where(accept, new, cur)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e8)
        return i + 1, poses, pts, lam, cur, small

    _, poses, pts, lam, cur, _ = jax.lax.while_loop(
        cond, body,
        (jnp.asarray(0, jnp.int32), poses, pts, lam0, cur0,
         jnp.asarray(0, jnp.int32)),
    )
    # project rotations back onto SO(3): chained f32 exp()@pose products
    # drift off the group, and downstream consumers (tracking's velocity
    # model, KF re-seeding) amplify the error (see se3.orthonormalize)
    poses = se3.orthonormalize(poses)
    return poses, pts, cur


def local_bundle_adjustment(cam: projection.Camera, prob: BAProblem,
                            n_iters_a: int = 5, n_iters_b: int = 10,
                            abort: jax.Array | None = None,
                            e_cap: int | None = None) -> BAResult:
    """The reference schedule: 5 iterations, outlier pruning, 10 more
    (`src/Optimizer.cc:660-717`). `abort` (scalar bool) skips phase B like
    `mbAbortBA` (`src/LocalMapping.cc:118`, checked between LM rounds).
    `e_cap` is accepted for API compatibility and ignored (the point-major
    solve works on the padded (L,O) table directly)."""
    del e_cap
    oh = _onehot_cam(prob)
    poses = prob.cam_pose
    pts = prob.pt_pos
    active = prob.obs_valid & (prob.obs_cam >= 0) & prob.pt_valid[:, None]
    struct = active
    lam0 = jnp.asarray(1e-4, pts.dtype)
    poses, pts, _ = _run_phase(cam, poses, pts, prob, oh, active,
                               jnp.asarray(True), n_iters_a, lam0)
    # prune: chi2 > gate or behind camera (Optimizer.cc:676-690)
    _, _, _, chi2, _, ok_z, is_st = _edge_terms_po(cam, poses, pts, prob, oh)
    gate = jnp.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO)
    active = active & (chi2 <= gate) & ok_z
    # (pruned lanes carry zero weight in the solve, so `oh` needs no mask)
    if abort is None:
        abort = jnp.asarray(False)

    def phase_b(args):
        poses, pts = args
        poses, pts, _ = _run_phase(cam, poses, pts, prob, oh, active,
                                   jnp.asarray(False), n_iters_b, lam0)
        return poses, pts

    poses, pts = jax.lax.cond(abort, lambda a: a, phase_b, (poses, pts))

    _, _, _, chi2, _, ok_z, is_st = _edge_terms_po(cam, poses, pts, prob, oh)
    inlier = struct & ok_z & (
        chi2 <= jnp.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO)
    )
    total = jnp.sum(jnp.where(inlier, chi2, 0.0))
    return BAResult(cam_pose=poses, pt_pos=pts, obs_inlier=inlier, chi2=total)


def global_bundle_adjustment(cam: projection.Camera, prob: BAProblem,
                             n_iters: int = 20,
                             e_cap: int | None = None) -> BAResult:
    """`Optimizer::GlobalBundleAdjustemnt` [sic] parity
    (`src/Optimizer.cc:41-47`): plain 20-iteration robust BA, first camera
    fixed by the caller via cam_fixed. `e_cap` ignored (point-major)."""
    del e_cap
    oh = _onehot_cam(prob)
    struct = prob.obs_valid & (prob.obs_cam >= 0) & prob.pt_valid[:, None]
    poses, pts, _ = _run_phase(
        cam, prob.cam_pose, prob.pt_pos, prob, oh, struct,
        jnp.asarray(True), n_iters, jnp.asarray(1e-4, prob.pt_pos.dtype)
    )
    _, _, _, chi2, _, ok_z, is_st = _edge_terms_po(cam, poses, pts, prob, oh)
    inlier = struct & ok_z & (
        chi2 <= jnp.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO)
    )
    total = jnp.sum(jnp.where(inlier, chi2, 0.0))
    return BAResult(cam_pose=poses, pt_pos=pts, obs_inlier=inlier, chi2=total)
