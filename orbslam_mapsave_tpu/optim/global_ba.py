"""Full-map bundle adjustment: implicit-Schur PCG, scatter-free.

`Optimizer::GlobalBundleAdjustemnt` [sic] / `Optimizer::BundleAdjustment`
parity (`src/Optimizer.cc:41-237`) at MAP scale: every valid keyframe and
every valid map point in one problem. The local-BA solver
(`optim/local_ba.py`) materializes the reduced camera system densely via a
(L,O,C) one-hot — exactly right for covisibility windows (C <= 64) and
exactly wrong for a full map (C = 512+, the one-hot alone would be >1 GB).

This solver never materializes S = Hcc - W Hpp^-1 W^T. The map's own dual
adjacency gives both reduction directions lane-locally, with NO scatters and
NO one-hot:

- point-major (P, O) tables (`pt_obs_kf/pt_obs_idx`) make every POINT-side
  reduction (Hpp, gp, W^T x) a lane-local sum;
- camera-major (K, N) tables (`kf_kp_point`) make every CAMERA-side
  reduction (Hcc, gc, W z) a lane-local sum;
- the Schur matvec S @ x chains the two: gather x to point lanes ->
  W^T x -> Hpp^-1 -> gather back to camera lanes -> W z. Gathers are
  vector loads; it is scatters that serialize.

The reduced camera system is solved EXACTLY by chunked dense-Schur assembly
+ Cholesky for live-map keyframe counts (K <= 384, `_solve_dense` — two
einsums per LM step, no inner-iteration truncation), falling back to
preconditioned conjugate gradients with a block-Jacobi (6x6 diagonal of S)
preconditioner — the "blocked PCG" called for by SURVEY.md §7.1-5/§7.3 —
for larger K and for the sharded multi-device path. LM damping, Huber
IRLS with the reference gates, gauge fixing on keyframe slot 0
(`src/Optimizer.cc:98-100`: setFixed(pKF->mnId==0)) and the abort flag
(`forceStopFlag`, checked between LM iterations) all match the reference's
semantics.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import projection, se3
from ..slammap import mapstate as ms
from . import lm

_BEHIND_PENALTY = 1e7  # see local_ba._BEHIND_PENALTY


class FullBATables(NamedTuple):
    """Static structure of the full-map problem in both layouts."""

    # point-major lanes (P,O): one row per map point, one lane per observation
    po_cam: jax.Array  # (P,O) i32 observing KF slot, -1 pad
    po_uv: jax.Array  # (P,O,2) undistorted pixels
    po_ur: jax.Array  # (P,O) right-u, <0 mono
    po_is2: jax.Array  # (P,O) inv sigma^2
    po_valid: jax.Array  # (P,O) bool
    # camera-major lanes (K,N): one row per keyframe, one lane per feature
    cm_pt: jax.Array  # (K,N) i32 observed point slot, -1 pad
    cm_uv: jax.Array  # (K,N,2)
    cm_ur: jax.Array  # (K,N)
    cm_is2: jax.Array  # (K,N)
    cm_valid: jax.Array  # (K,N) bool
    # vertex masks
    cam_free: jax.Array  # (K,) bool — valid and not gauge-fixed
    cam_valid: jax.Array  # (K,) bool
    pt_valid: jax.Array  # (P,) bool


O_GBA = 16  # observation lanes per point in the full-map problem (of
# MAX_OBS=32): rows fill front-to-back, so this drops only tail
# observations of the rare >16-observer points while halving every (P,O)
# lane tensor — including the (P,O,K) one-hot, the solver's largest
# resident tensor


def build_tables(state: ms.MapState, inv_level_sigma2: jax.Array,
                 fixed_mask: jax.Array | None = None) -> FullBATables:
    """Assemble both edge layouts straight from the SoA map state.

    The forward table (`kf_kp_point`) can hold edges whose reverse lane was
    dropped at MAX_OBS capacity (`add_observations` skips full rows); such
    one-sided edges are masked out of the camera-major layout so both
    layouts describe the SAME edge set — PCG needs the operator consistent.
    Both layouts see only the first O_GBA reverse lanes, keeping the edge
    sets identical.
    """
    K, N = state.kf_kp_point.shape
    P = state.pt_obs_kf.shape[0]
    n_lv = inv_level_sigma2.shape[0]

    # --- point-major ---
    o_kf = state.pt_obs_kf[:, :O_GBA]
    o_ix = state.pt_obs_idx[:, :O_GBA]
    po_live = (o_kf >= 0) & state.pt_valid[:, None]
    po_live = po_live & state.kf_valid[jnp.clip(o_kf, 0)]
    sk, si = jnp.clip(o_kf, 0), jnp.clip(o_ix, 0)
    po_uv = state.kf_kp_xy[sk, si]
    po_ur = state.kf_kp_ur[sk, si]
    po_oct = state.kf_kp_octave[sk, si]
    po_is2 = inv_level_sigma2[jnp.clip(po_oct, 0, n_lv - 1)]

    # --- camera-major ---
    c_pt = state.kf_kp_point
    cm_live = (c_pt >= 0) & state.kf_valid[:, None]
    cm_live = cm_live & state.pt_valid[jnp.clip(c_pt, 0)]
    # reverse-lane existence: any lane of pt_obs rows matches (k, n)
    rev_kf = state.pt_obs_kf[:, :O_GBA][jnp.clip(c_pt, 0)]  # (K,N,O_GBA)
    rev_ix = state.pt_obs_idx[:, :O_GBA][jnp.clip(c_pt, 0)]
    k_ids = jnp.arange(K, dtype=jnp.int32)[:, None, None]
    n_ids = jnp.arange(N, dtype=jnp.int32)[None, :, None]
    has_rev = ((rev_kf == k_ids) & (rev_ix == n_ids)).any(-1)
    cm_live = cm_live & has_rev
    cm_uv = state.kf_kp_xy
    cm_ur = state.kf_kp_ur
    cm_is2 = inv_level_sigma2[jnp.clip(state.kf_kp_octave, 0, n_lv - 1)]

    if fixed_mask is None:
        fixed_mask = jnp.zeros(K, bool).at[0].set(True)
    cam_free = state.kf_valid & ~fixed_mask
    return FullBATables(
        po_cam=jnp.where(po_live, o_kf, -1), po_uv=po_uv, po_ur=po_ur,
        po_is2=po_is2, po_valid=po_live,
        cm_pt=jnp.where(cm_live, c_pt, -1), cm_uv=cm_uv, cm_ur=cm_ur,
        cm_is2=cm_is2, cm_valid=cm_live,
        cam_free=cam_free, cam_valid=state.kf_valid,
        pt_valid=state.pt_valid,
    )


def _edge_terms(cam: projection.Camera, pose_lane, pt_lane, uv, ur, is2):
    """Residual/Jacobian blocks for one lane layout.

    pose_lane (...,4,4) and pt_lane (...,3) are pre-gathered per lane.
    Returns r (...,3), Jc (...,3,6), Jp (...,3,3), chi2 (...), ok_z, is_st.
    Mirrors g2o's mono/stereo projection edges
    (`types_six_dof_expmap.h:80-174`), stereo row zeroed for mono.
    """
    R = pose_lane[..., :3, :3]
    p_cam = jnp.sum(R * pt_lane[..., None, :], axis=-1) + pose_lane[..., :3, 3]
    z = p_cam[..., 2]
    ok_z = z > 1e-6
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * p_cam[..., 0] / zs + cam.cx
    v = cam.fy * p_cam[..., 1] / zs + cam.cy
    ur_pred = u - cam.bf / zs
    is_st = ur >= 0
    r = jnp.stack(
        [uv[..., 0] - u, uv[..., 1] - v,
         jnp.where(is_st, ur - ur_pred, 0.0)], axis=-1,
    )
    J_proj = lm.proj_jacobian(p_cam, cam.fx, cam.fy)  # (...,2,3)
    zi2 = 1.0 / (zs * zs)
    dur_dp = J_proj[..., 0, :] + jnp.stack(
        [jnp.zeros_like(z), jnp.zeros_like(z), cam.bf * zi2], axis=-1
    )
    dur_dp = jnp.where(is_st[..., None], dur_dp, 0.0)
    A = jnp.concatenate([J_proj, dur_dp[..., None, :]], axis=-2)  # (...,3,3)
    Jc_pt = lm.point_pose_jacobian(p_cam)  # (...,3,6)
    Jc = -jnp.sum(A[..., :, :, None] * Jc_pt[..., None, :, :], axis=-2)
    Jp = -jnp.sum(A[..., :, :, None] * R[..., None, :, :], axis=-2)
    chi2 = jnp.sum(r * r, -1) * is2
    return r, Jc, Jp, chi2, ok_z, is_st


def _onehot_po(tb: FullBATables, K: int) -> jax.Array:
    """(P,O,K) f32 one-hot of each lane's observing camera, built ONCE per
    solve. Every camera-side selection/reduction in the solver runs as an
    einsum against this instead of a row gather; whether that still beats
    a plain gather on the GPU is unmeasured (ROADMAP Queue 3). Invalid lanes (po_cam = -1) get all-zero rows."""
    ids = jnp.arange(K, dtype=jnp.int32)
    return (tb.po_cam[..., None] == ids).astype(jnp.float32)


def _po_terms(cam, poses, pts, tb: FullBATables, oh: jax.Array | None = None):
    if oh is None:
        pose_lane = poses[jnp.clip(tb.po_cam, 0)]  # (P,O,4,4) gather
    else:
        K = poses.shape[0]
        pose_lane = jnp.einsum(
            "pok,kf->pof", oh, poses.reshape(K, 16),
            precision=lm.HI).reshape(oh.shape[0], oh.shape[1], 4, 4)
        # one-hot selection is exact at HIGHEST precision (1.0 * v splits
        # as v_hi + v_lo); invalid lanes select the zero matrix, whose
        # projection terms are masked by po_valid downstream
    pt_lane = pts[:, None, :]
    return _edge_terms(cam, pose_lane, pt_lane, tb.po_uv, tb.po_ur, tb.po_is2)


def _cm_terms(cam, poses, pts, tb: FullBATables):
    pose_lane = poses[:, None]  # broadcast (K,1,4,4)
    pt_lane = pts[jnp.clip(tb.cm_pt, 0)]  # (K,N,3) gather
    return _edge_terms(cam, pose_lane, pt_lane, tb.cm_uv, tb.cm_ur, tb.cm_is2)


def _accept_cost(cam, poses, pts, tb: FullBATables, robust, oh=None):
    """LM acceptance objective over the point-major lanes (Huber chi2 with
    a fixed penalty for behind-camera projections; see local_ba)."""
    _, _, _, chi2, ok_z, is_st = _po_terms(cam, poses, pts, tb, oh)
    delta2 = jnp.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO)
    d = jnp.sqrt(delta2)
    rho = jnp.where(chi2 <= delta2, chi2,
                    2.0 * d * jnp.sqrt(jnp.maximum(chi2, 0)) - delta2)
    val = jnp.where(robust, rho, chi2)
    val = jnp.where(ok_z, val, _BEHIND_PENALTY)
    val = jnp.where(jnp.isfinite(val), val, _BEHIND_PENALTY)
    return jnp.sum(jnp.where(tb.po_valid, val, 0.0))


def _weights(chi2, ok_z, live, is2, is_st, robust):
    delta2 = jnp.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO)
    w_rob = jnp.where(robust, lm.huber_weight(chi2, delta2), 1.0)
    return jnp.where(live & ok_z, is2 * w_rob, 0.0)


def _schur_blocks(cam, poses, pts, tb: FullBATables, robust, lam,
                  oh: jax.Array):
    """Shared LM-step prologue for both camera-system solvers: per-lane
    residual blocks reduced to (Hpp_inv, W_po, WH, Hcc_d, rhs, gp, pt_has).
    """
    K = poses.shape[0]
    dtype = pts.dtype

    # ---- point-major blocks ----
    r_po, Jc_po, Jp_po, chi2_po, okz_po, st_po = _po_terms(
        cam, poses, pts, tb, oh)
    free_lane_po = (jnp.einsum("pok,k->po", oh,
                               tb.cam_free.astype(jnp.float32),
                               precision=lm.HI) > 0.5) & tb.po_valid
    Jc_po = jnp.where(free_lane_po[..., None, None], Jc_po, 0.0)
    w_po = _weights(chi2_po, okz_po, tb.po_valid, tb.po_is2, st_po, robust)
    wJp = Jp_po * w_po[..., None, None]
    wJc = Jc_po * w_po[..., None, None]
    Hpp = jnp.sum(wJp[..., :, :, None] * Jp_po[..., :, None, :],
                  axis=(1, 2))  # (P,3,3)
    gp = -jnp.sum(wJp * r_po[..., None], axis=(1, 2))  # (P,3)
    W_po = jnp.sum(wJc[..., :, :, None] * Jp_po[..., :, None, :],
                   axis=-3)  # (P,O,6,3)

    pt_has = (jnp.sum(w_po, -1) > 0) & tb.pt_valid
    eye3 = jnp.eye(3, dtype=dtype)
    Hpp_diag = jnp.diagonal(Hpp, axis1=-2, axis2=-1)
    Hpp_d = Hpp + eye3 * (lam * Hpp_diag + 1e-8)[..., None]
    Hpp_inv = lm.inv3x3(jnp.where(pt_has[:, None, None], Hpp_d, eye3[None]))
    Hpp_inv = jnp.where(pt_has[:, None, None], Hpp_inv, 0.0)

    # ---- camera blocks by one-hot contraction over the same lanes ----
    JcwJc = jnp.sum(wJc[..., :, :, None] * Jc_po[..., :, None, :],
                    axis=-3)  # (P,O,6,6) per-lane Jc^T w Jc
    Hcc = jnp.einsum("pok,poab->kab", oh, JcwJc, precision=lm.HI)
    gc = -jnp.einsum("pok,poa->ka", oh,
                     jnp.sum(wJc * r_po[..., None], axis=-2),
                     precision=lm.HI)

    # damped camera diagonal; identity rows for fixed/invalid cams
    eye6 = jnp.eye(6, dtype=dtype)
    Hcc_diag = jnp.diagonal(Hcc, axis1=-2, axis2=-1)
    Hcc_d = Hcc + eye6 * (lam * Hcc_diag + 1e-8)[..., None]
    Hcc_d = jnp.where(tb.cam_free[:, None, None], Hcc_d, eye6[None])

    # WH = W Hpp^-1 per lane; rhs = gc - W Hpp^-1 gp
    WH = jnp.einsum("poab,pbc->poac", W_po, Hpp_inv,
                    precision=lm.HI)  # (P,O,6,3)
    gp_z = jnp.sum(Hpp_inv * gp[:, None, :], axis=-1)  # (P,3)
    rhs = gc - jnp.einsum(
        "pok,poa->ka", oh,
        jnp.sum(W_po * gp_z[:, None, None, :], axis=-1), precision=lm.HI)
    rhs = jnp.where(tb.cam_free[:, None], rhs, 0.0)
    return W_po, WH, Hpp_inv, Hcc_d, rhs, gp, pt_has


def _backsub_points(tb, oh, W_po, Hpp_inv, gp, pt_has, dx_cam):
    """dx_p = Hpp^-1 (gp - W^T dx_cam)."""
    dx_lane = jnp.einsum("pok,ka->poa", oh, dx_cam, precision=lm.HI)
    Wt_dx = jnp.sum(W_po * dx_lane[..., :, None], axis=(1, 2))  # (P,3)
    dx_pt = jnp.sum(Hpp_inv * (gp - Wt_dx)[:, None, :], axis=-1)
    dx_pt = jnp.where((pt_has & tb.pt_valid)[:, None], dx_pt, 0.0)
    return jnp.where(jnp.isfinite(dx_pt), dx_pt, 0.0)


def _solve_dense(cam, poses, pts, tb: FullBATables, robust, lam,
                 oh: jax.Array, n_chunks: int = 8):
    """One damped LM step with the reduced camera system MATERIALIZED and
    Cholesky-solved — exact, no inner-iteration truncation.

    DESIGN: for the keyframe counts a live map holds (K <= a few hundred;
    the reference culls keyframes aggressively, `src/LocalMapping.cc:632`),
    the dense (6K,6K) Schur complement is small (384^2 at K=64, 1536^2 at
    K=256) and its assembly is two einsums over the point lanes — the
    inexact-PCG path needed ~100 matvecs of the SAME lane traffic per LM
    iteration to reach comparable accuracy (an under-capped CG cost the r4
    bench 0.017 m vs 0.007 m keyframe ATE, tools/ate_probe.py). PCG remains
    the fallback for K beyond dense reach and for the sharded multi-device
    path (parallel/dist_gba.py).

    The off-diagonal assembly S -= sum_p A_p B_p^T runs in `n_chunks`
    point-chunks so the (P,K,6,3) camera stacks never materialize whole
    (at K=256, P=64k a full stack would be ~1.2 GB).
    """
    K = poses.shape[0]
    dtype = pts.dtype
    W_po, WH, Hpp_inv, Hcc_d, rhs, gp, pt_has = _schur_blocks(
        cam, poses, pts, tb, robust, lam, oh)

    P, O = W_po.shape[:2]
    nc = n_chunks if P % n_chunks == 0 else 1
    pc = P // nc
    oh_c = oh.reshape(nc, pc, O, K)
    WH_c = WH.reshape(nc, pc, O, 6, 3)
    W_c = W_po.reshape(nc, pc, O, 6, 3)

    def chunk(S, args):
        oh_i, WH_i, W_i = args
        A = jnp.einsum("pok,poai->pkai", oh_i, WH_i, precision=lm.HI)
        B = jnp.einsum("pok,poai->pkai", oh_i, W_i, precision=lm.HI)
        S = S - jnp.einsum("pkai,plbi->kalb", A, B, precision=lm.HI)
        return S, None

    S0 = jnp.zeros((K, 6, K, 6), dtype)
    idx = jnp.arange(K)
    S0 = S0.at[idx, :, idx, :].set(Hcc_d)
    S, _ = jax.lax.scan(chunk, S0, (oh_c, WH_c, W_c))

    # flatten; fixed/invalid cams already have identity diagonal rows and
    # zero couplings (their lanes carry zeroed Jc), but mask for safety
    Sf = S.reshape(K * 6, K * 6)
    mask = jnp.repeat(tb.cam_free, 6)
    Sf = jnp.where(mask[:, None] & mask[None, :], Sf, 0.0)
    Sf = Sf + jnp.diag(jnp.where(mask, 0.0, 1.0))
    chol = jax.scipy.linalg.cho_factor(Sf, lower=True)
    dx_cam = jax.scipy.linalg.cho_solve(chol, rhs.reshape(-1)).reshape(K, 6)
    dx_cam = jnp.where(jnp.isfinite(dx_cam) & tb.cam_free[:, None], dx_cam,
                       0.0)
    dx_pt = _backsub_points(tb, oh, W_po, Hpp_inv, gp, pt_has, dx_cam)
    return dx_cam, dx_pt


def _solve_pcg(cam, poses, pts, tb: FullBATables, robust, lam,
               cg_iters: int, cg_tol: float, oh: jax.Array | None = None):
    """One damped LM step via PCG on the implicit Schur complement.

    Returns (dx_cam (K,6), dx_pt (P,3)). Single point-major layout: every
    camera-side reduction (Hcc, gc, W·z, the block-Jacobi diagonal) is a
    one-hot contraction against `oh` over the SAME (P,O) lanes — the old
    dual-layout form needed two row gathers per CG matvec plus a full
    camera-major term pass (see `_onehot_po`).
    """
    K = poses.shape[0]
    dtype = pts.dtype
    if oh is None:
        oh = _onehot_po(tb, K)
    W_po, WH, Hpp_inv, Hcc_d, rhs, gp, pt_has = _schur_blocks(
        cam, poses, pts, tb, robust, lam, oh)

    def matvec(x):  # x (K,6) -> (K,6)
        a = jnp.sum(Hcc_d * x[:, None, :], axis=-1)  # (K,6)
        x_lane = jnp.einsum("pok,ka->poa", oh, x, precision=lm.HI)
        t = jnp.sum(W_po * x_lane[..., :, None], axis=(1, 2))  # (P,3)
        z = jnp.sum(Hpp_inv * t[:, None, :], axis=-1)  # (P,3)
        contrib = jnp.sum(W_po * z[:, None, None, :], axis=-1)  # (P,O,6)
        b = jnp.einsum("pok,poa->ka", oh, contrib, precision=lm.HI)
        return a - b

    # block-Jacobi preconditioner: exact 6x6 diagonal of S (lane-local
    # W Hpp^-1 W^T, contracted to cameras)
    eye6 = jnp.eye(6, dtype=dtype)
    WHW = jnp.einsum("poac,podc->poad", WH, W_po,
                     precision=lm.HI)  # (P,O,6,6)
    S_diag = Hcc_d - jnp.einsum("pok,poab->kab", oh, WHW, precision=lm.HI)
    S_diag = jnp.where(tb.cam_free[:, None, None], S_diag, eye6[None])
    Minv = jnp.linalg.inv(S_diag)
    Minv = jnp.where(jnp.isfinite(Minv), Minv, eye6[None])

    def apply_minv(r):
        return jnp.sum(Minv * r[:, None, :], axis=-1)

    # ---- PCG ----
    rhs_norm = jnp.sqrt(jnp.sum(rhs * rhs))
    tol = cg_tol * jnp.maximum(rhs_norm, 1e-20)
    x0 = jnp.zeros((K, 6), dtype)
    r0 = rhs
    z0 = apply_minv(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)

    def cond(carry):
        i, x, r, p, rz = carry
        return (i < cg_iters) & (jnp.sqrt(jnp.sum(r * r)) > tol)

    def body(carry):
        i, x, r, p, rz = carry
        Ap = matvec(p)
        pAp = jnp.sum(p * Ap)
        alpha = rz / jnp.where(jnp.abs(pAp) < 1e-30, 1e-30, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_minv(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
        p = z + beta * p
        return i + 1, x, r, p, rz_new

    _, dx_cam, _, _, _ = jax.lax.while_loop(cond, body, (0, x0, r0, p0, rz0))
    dx_cam = jnp.where(jnp.isfinite(dx_cam) & tb.cam_free[:, None], dx_cam, 0.0)
    dx_pt = _backsub_points(tb, oh, W_po, Hpp_inv, gp, pt_has, dx_cam)
    return dx_cam, dx_pt


class PlanarBATables(NamedTuple):
    """Flat-lane (1-D plane) layout of the full-map problem — the
    reference-scale storage: 1-D planes of the lanes instead of
    (lanes, small, small) tensors, whose trailing dims a tiled memory
    layout pads. Point-major lanes
    are stored flat (E = P*O) and reshaped (fused) at reduction time;
    camera-major lanes likewise (Ec = K*N)."""

    po_idx: jax.Array  # (E,) i32 observing KF slot per point-major lane
    po_pt: jax.Array  # (E,) i32 the lane's point slot (p = lane // O)
    po_u: jax.Array  # (E,)
    po_v: jax.Array  # (E,)
    po_ur: jax.Array  # (E,)
    po_is2: jax.Array  # (E,)
    po_valid: jax.Array  # (E,) bool
    cm_pt: jax.Array  # (Ec,) i32 observed point slot per camera-major lane
    cm_cam: jax.Array  # (Ec,) i32 the lane's camera slot (k = lane // N)
    cm_u: jax.Array  # (Ec,)
    cm_v: jax.Array  # (Ec,)
    cm_ur: jax.Array  # (Ec,)
    cm_is2: jax.Array  # (Ec,)
    cm_valid: jax.Array  # (Ec,) bool
    cam_free: jax.Array  # (K,) bool
    cam_valid: jax.Array  # (K,)
    pt_valid: jax.Array  # (P,)
    # (P, O, K, N are derived from array shapes — a stored int tuple would
    # become TRACED leaves when the tables pass through a jit boundary)


def build_planar_tables(state: ms.MapState, inv_level_sigma2: jax.Array,
                        fixed_mask: jax.Array | None = None
                        ) -> PlanarBATables:
    """`build_tables` in the flat-lane layout (same edge-set semantics)."""
    K, N = state.kf_kp_point.shape
    P = state.pt_obs_kf.shape[0]
    O = O_GBA
    n_lv = inv_level_sigma2.shape[0]
    o_kf = state.pt_obs_kf[:, :O]
    o_ix = state.pt_obs_idx[:, :O]
    po_live = (o_kf >= 0) & state.pt_valid[:, None]
    po_live = po_live & state.kf_valid[jnp.clip(o_kf, 0)]
    sk, si = jnp.clip(o_kf, 0), jnp.clip(o_ix, 0)
    po_u = state.kf_kp_xy[..., 0][sk, si].reshape(-1)
    po_v = state.kf_kp_xy[..., 1][sk, si].reshape(-1)
    po_ur = state.kf_kp_ur[sk, si].reshape(-1)
    po_oct = state.kf_kp_octave[sk, si]
    po_is2 = inv_level_sigma2[jnp.clip(po_oct, 0, n_lv - 1)].reshape(-1)
    po_pt = jnp.repeat(jnp.arange(P, dtype=jnp.int32), O)

    c_pt = state.kf_kp_point
    cm_live = (c_pt >= 0) & state.kf_valid[:, None]
    cm_live = cm_live & state.pt_valid[jnp.clip(c_pt, 0)]
    rev_kf = state.pt_obs_kf[:, :O][jnp.clip(c_pt, 0)]
    rev_ix = state.pt_obs_idx[:, :O][jnp.clip(c_pt, 0)]
    k_ids = jnp.arange(K, dtype=jnp.int32)[:, None, None]
    n_ids = jnp.arange(N, dtype=jnp.int32)[None, :, None]
    has_rev = ((rev_kf == k_ids) & (rev_ix == n_ids)).any(-1)
    cm_live = cm_live & has_rev
    cm_is2 = inv_level_sigma2[
        jnp.clip(state.kf_kp_octave, 0, n_lv - 1)].reshape(-1)
    if fixed_mask is None:
        fixed_mask = jnp.zeros(K, bool).at[0].set(True)
    return PlanarBATables(
        po_idx=jnp.where(po_live, o_kf, -1).reshape(-1),
        po_pt=po_pt,
        po_u=po_u, po_v=po_v, po_ur=po_ur, po_is2=po_is2,
        po_valid=po_live.reshape(-1),
        cm_pt=jnp.where(cm_live, c_pt, -1).reshape(-1),
        cm_cam=jnp.repeat(jnp.arange(K, dtype=jnp.int32), N),
        cm_u=state.kf_kp_xy[..., 0].reshape(-1),
        cm_v=state.kf_kp_xy[..., 1].reshape(-1),
        cm_ur=state.kf_kp_ur.reshape(-1),
        cm_is2=cm_is2,
        cm_valid=cm_live.reshape(-1),
        cam_free=state.kf_valid & ~fixed_mask,
        cam_valid=state.kf_valid,
        pt_valid=state.pt_valid,
    )


def _take_pose_planes(poses: jax.Array, idx: jax.Array):
    """12 1-D gathers of a (K,4,4) pose table -> (R (3,3,E), t (3,E))."""
    R = [[jnp.take(poses[:, i, j], idx) for j in range(3)]
         for i in range(3)]
    t = [jnp.take(poses[:, i, 3], idx) for i in range(3)]
    return R, t


def _planar_edge_terms(cam, R, t, X, u_obs, v_obs, ur_obs, is2):
    """Edge terms with every quantity a 1-D plane (R: 3x3 list of (E,),
    t/X: 3-lists). Returns r (3 planes), Jc (3x6 planes), Jp (3x3 planes),
    chi2, ok_z, is_st — identical math to `_edge_terms`."""
    p = [R[i][0] * X[0] + R[i][1] * X[1] + R[i][2] * X[2] + t[i]
         for i in range(3)]
    z = p[2]
    ok_z = z > 1e-6
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    zi = 1.0 / zs
    zi2 = zi * zi
    u = cam.fx * p[0] * zi + cam.cx
    v = cam.fy * p[1] * zi + cam.cy
    ur_pred = u - cam.bf * zi
    is_st = ur_obs >= 0
    zero = jnp.zeros_like(z)
    r = [u_obs - u, v_obs - v,
         jnp.where(is_st, ur_obs - ur_pred, 0.0)]
    # A = [du/dp; dv/dp; dur/dp (stereo only)] (3x3 planes)
    A = [[cam.fx * zi, zero, -cam.fx * p[0] * zi2],
         [zero, cam.fy * zi, -cam.fy * p[1] * zi2],
         [jnp.where(is_st, cam.fx * zi, 0.0), zero,
          jnp.where(is_st, -cam.fx * p[0] * zi2 + cam.bf * zi2, 0.0)]]
    # Jc_pt = [I | -hat(p)] (3x6); Jc = -A @ Jc_pt, Jp = -A @ R
    hat = [[zero, -p[2], p[1]], [p[2], zero, -p[0]], [-p[1], p[0], zero]]
    Jc = [[None] * 6 for _ in range(3)]
    Jp = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            Jc[i][j] = -A[i][j]  # translation block: -A @ I
            Jc[i][3 + j] = sum(A[i][k] * hat[k][j] for k in range(3))
            Jp[i][j] = -sum(A[i][k] * R[k][j] for k in range(3))
    chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * is2
    return r, Jc, Jp, chi2, ok_z, is_st


def _planar_po_terms(cam, poses, pts, tb: PlanarBATables):
    R, t = _take_pose_planes(poses, jnp.clip(tb.po_idx, 0))
    X = [jnp.take(pts[:, c], tb.po_pt) for c in range(3)]
    return _planar_edge_terms(cam, R, t, X, tb.po_u, tb.po_v, tb.po_ur,
                              tb.po_is2)


def _planar_cm_terms(cam, poses, pts, tb: PlanarBATables):
    R, t = _take_pose_planes(poses, tb.cm_cam)
    safe = jnp.clip(tb.cm_pt, 0)
    X = [jnp.take(pts[:, c], safe) for c in range(3)]
    return _planar_edge_terms(cam, R, t, X, tb.cm_u, tb.cm_v, tb.cm_ur,
                              tb.cm_is2)


def _accept_cost_planar(cam, poses, pts, tb: PlanarBATables, robust):
    _, _, _, chi2, ok_z, is_st = _planar_po_terms(cam, poses, pts, tb)
    delta2 = jnp.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO)
    d = jnp.sqrt(delta2)
    rho = jnp.where(chi2 <= delta2, chi2,
                    2.0 * d * jnp.sqrt(jnp.maximum(chi2, 0)) - delta2)
    val = jnp.where(robust, rho, chi2)
    val = jnp.where(ok_z, val, _BEHIND_PENALTY)
    val = jnp.where(jnp.isfinite(val), val, _BEHIND_PENALTY)
    return jnp.sum(jnp.where(tb.po_valid, val, 0.0))


def _inv3x3_planar(H):
    """Adjugate inverse of a 3x3 list-of-planes matrix."""
    a, b, c = H[0]
    d, e, f = H[1]
    g, h, i = H[2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    idet = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    return [[A11 * idet, A12 * idet, A13 * idet],
            [A21 * idet, A22 * idet, A23 * idet],
            [A31 * idet, A32 * idet, A33 * idet]]


def _solve_pcg_planar(cam, poses, pts, tb: PlanarBATables, robust, lam,
                      cg_iters: int, cg_tol: float):
    """One damped LM step via PCG, everything in flat-lane planes — the
    reference-scale solver (no (P,O,K) one-hot, no (lanes,·,·) tensors;
    see PlanarBATables). Camera-side state lives as (K,6)/(K,6,6) (small
    leading dims — benign padding); point-side blocks as 1-D (P,) planes.
    Preconditioner: damped-Hcc block-Jacobi. Returns (dx_cam, dx_pt)."""
    P = tb.pt_valid.shape[0]
    O = tb.po_valid.shape[0] // P
    K = tb.cam_free.shape[0]
    N = tb.cm_valid.shape[0] // K
    dtype = pts.dtype

    def weights(chi2, ok_z, live, is2, is_st):
        delta2 = jnp.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO)
        w_rob = jnp.where(robust, lm.huber_weight(chi2, delta2), 1.0)
        return jnp.where(live & ok_z, is2 * w_rob, 0.0)

    # ---- point-major blocks ----
    r, Jc, Jp, chi2, ok_z, is_st = _planar_po_terms(cam, poses, pts, tb)
    free_lane = jnp.take(tb.cam_free, jnp.clip(tb.po_idx, 0)) & tb.po_valid
    w = weights(chi2, ok_z, tb.po_valid, tb.po_is2, is_st)
    wf = jnp.where(free_lane, w, 0.0)  # weight for camera-side terms

    def po_sum(plane):  # (E,) -> (P,) lane sum per point
        return jnp.sum(plane.reshape(P, O), axis=1)

    # Hpp[a][b] = sum_r w * Jp[r][a] * Jp[r][b]  (per point)
    Hpp = [[po_sum(sum(w * Jp[k][a] * Jp[k][b] for k in range(3)))
            for b in range(3)] for a in range(3)]
    gp = [-po_sum(sum(w * Jp[k][a] * r[k] for k in range(3)))
          for a in range(3)]
    pt_has = (po_sum(w) > 0) & tb.pt_valid
    Hpp_d = [[Hpp[a][b] + (lam * Hpp[a][a] + 1e-8) * (a == b)
              for b in range(3)] for a in range(3)]
    Hpp_d = [[jnp.where(pt_has, Hpp_d[a][b], 1.0 * (a == b))
              for b in range(3)] for a in range(3)]
    Hpp_inv = _inv3x3_planar(Hpp_d)
    Hpp_inv = [[jnp.where(pt_has, Hpp_inv[a][b], 0.0) for b in range(3)]
               for a in range(3)]
    # per-lane W blocks (6x3 planes), masked by the free-camera weight
    W_po = [[sum(wf * Jc[k][a] * Jp[k][b] for k in range(3))
             for b in range(3)] for a in range(6)]

    # ---- camera-major blocks ----
    rc, Jcc, Jpc, chi2c, okzc, istc = _planar_cm_terms(cam, poses, pts, tb)
    free_cm = jnp.take(tb.cam_free, tb.cm_cam) & tb.cm_valid
    wc = weights(chi2c, okzc, tb.cm_valid, tb.cm_is2, istc)
    wcf = jnp.where(free_cm, wc, 0.0)

    def cm_sum(plane):  # (Ec,) -> (K,)
        return jnp.sum(plane.reshape(K, N), axis=1)

    Hcc = jnp.stack([jnp.stack([
        cm_sum(sum(wcf * Jcc[k][a] * Jcc[k][b] for k in range(3)))
        for b in range(6)], -1) for a in range(6)], -2)  # (K,6,6)
    gc = jnp.stack([
        -cm_sum(sum(wcf * Jcc[k][a] * rc[k] for k in range(3)))
        for a in range(6)], -1)  # (K,6)
    W_cm = [[sum(wcf * Jcc[k][a] * Jpc[k][b] for k in range(3))
             for b in range(3)] for a in range(6)]
    eye6 = jnp.eye(6, dtype=dtype)
    Hcc_diag = jnp.diagonal(Hcc, axis1=-2, axis2=-1)
    Hcc_d = Hcc + eye6 * (lam * Hcc_diag + 1e-8)[..., None]
    Hcc_d = jnp.where(tb.cam_free[:, None, None], Hcc_d, eye6[None])

    def hpp_apply(vec3):  # Hpp_inv @ (P,)-planes vector
        return [sum(Hpp_inv[a][b] * vec3[b] for b in range(3))
                for a in range(3)]

    # rhs = gc - W Hpp^-1 gp
    gpz = hpp_apply(gp)
    gpz_lane = [jnp.take(gpz[b], jnp.clip(tb.cm_pt, 0)) for b in range(3)]
    rhs = gc - jnp.stack([
        cm_sum(sum(W_cm[a][b] * gpz_lane[b] for b in range(3)))
        for a in range(6)], -1)
    rhs = jnp.where(tb.cam_free[:, None], rhs, 0.0)

    po_cam_safe = jnp.clip(tb.po_idx, 0)
    cm_pt_safe = jnp.clip(tb.cm_pt, 0)

    def matvec(x):  # (K,6)
        a_term = jnp.sum(Hcc_d * x[:, None, :], axis=-1)
        x_lane = [jnp.take(x[:, a], po_cam_safe) for a in range(6)]
        t3 = [po_sum(sum(W_po[a][b] * x_lane[a] for a in range(6)))
              for b in range(3)]
        z3 = hpp_apply(t3)
        z_lane = [jnp.take(z3[b], cm_pt_safe) for b in range(3)]
        b_term = jnp.stack([
            cm_sum(sum(W_cm[a][b] * z_lane[b] for b in range(3)))
            for a in range(6)], -1)
        return a_term - b_term

    Minv = jnp.linalg.inv(Hcc_d)
    Minv = jnp.where(jnp.isfinite(Minv), Minv, eye6[None])

    def apply_minv(v):
        return jnp.sum(Minv * v[:, None, :], axis=-1)

    x0 = jnp.zeros((K, 6), dtype)
    r0 = rhs
    p0 = apply_minv(r0)
    rz0 = jnp.sum(r0 * p0)
    rhs_norm = jnp.sqrt(jnp.sum(rhs * rhs)) + 1e-30

    def cond(c):
        i, x, rr, p, rz = c
        return (i < cg_iters) & (jnp.sqrt(jnp.sum(rr * rr)) / rhs_norm
                                 > cg_tol)

    def body(c):
        i, x, rr, p, rz = c
        Ap = matvec(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-30)
        x = x + alpha * p
        rr = rr - alpha * Ap
        z = apply_minv(rr)
        rz_new = jnp.sum(rr * z)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
        p = z + beta * p
        return i + 1, x, rr, p, rz_new

    _, dx_cam, _, _, _ = jax.lax.while_loop(cond, body, (0, x0, r0, p0, rz0))
    dx_cam = jnp.where(jnp.isfinite(dx_cam) & tb.cam_free[:, None],
                       dx_cam, 0.0)
    # back-substitute landmarks
    dx_lane = [jnp.take(dx_cam[:, a], po_cam_safe) for a in range(6)]
    Wt_dx = [po_sum(sum(W_po[a][b] * dx_lane[a] for a in range(6)))
             for b in range(3)]
    dxp = hpp_apply([gp[b] - Wt_dx[b] for b in range(3)])
    dx_pt = jnp.stack(dxp, -1)
    dx_pt = jnp.where(pt_has[:, None], dx_pt, 0.0)
    dx_pt = jnp.where(jnp.isfinite(dx_pt), dx_pt, 0.0)
    return dx_cam, dx_pt


@partial(jax.jit,
         static_argnames=("n_iters", "robust", "cg_iters", "solver"))
def full_bundle_adjustment(cam: projection.Camera, state: ms.MapState,
                           inv_level_sigma2: jax.Array,
                           n_iters: int = 10, robust: bool = False,
                           cg_iters: int = 100, cg_tol: float = 1e-3,
                           abort: jax.Array | None = None,
                           fixed_mask: jax.Array | None = None,
                           solver: str = "auto"):
    """Full-map BA over EVERY valid keyframe and point.

    Parity: the loop-closing GBA runs 10 non-robust iterations
    (`src/LoopClosing.cc:647` -> `Optimizer.cc:41-47` with bRobust=false);
    the mono-init GBA runs 20 robust ones (`src/Tracking.cc:931`). `abort`
    mirrors `mbStopGBA`/forceStopFlag: checked between LM iterations, a set
    flag freezes the remaining iterations (the reference discards the
    result; freezing keeps jit shapes static — callers check the flag).

    Returns (kf_pose (K,4,4), pt_pos (P,3), final_cost).
    """
    poses = state.kf_pose
    pts = state.pt_pos
    K = poses.shape[0]
    robust_flag = jnp.asarray(robust)
    if abort is None:
        abort = jnp.asarray(False)
    # "auto" thresholds on the PADDED capacity K (the only shape visible
    # under jit); callers that know the live count should pass the solver
    # explicitly (pipeline/gba.GBAJob does). "pcg_dual" uses the planar
    # flat-lane tables — the reference-scale path (K >= 1024), where both
    # the (P,O,K) one-hot AND any (lanes,·,·) small-trailing-dim tensor
    # are memory-impossible at that capacity.
    use_dense = solver == "dense" or (solver == "auto" and K <= 384)
    if solver == "pcg_dual":
        tb = build_planar_tables(state, jnp.asarray(inv_level_sigma2),
                                 fixed_mask)
        oh = None
        cur0 = _accept_cost_planar(cam, poses, pts, tb, robust_flag)
    else:
        tb = build_tables(state, jnp.asarray(inv_level_sigma2), fixed_mask)
        oh = _onehot_po(tb, K) if (use_dense or solver == "pcg") else None
        cur0 = _accept_cost(cam, poses, pts, tb, robust_flag, oh)
    free = tb.cam_free[:, None]

    def body(carry, _):
        poses, pts, lam, cur = carry

        def step(args):
            poses, pts, lam, cur = args
            if use_dense:
                dxc, dxp = _solve_dense(cam, poses, pts, tb, robust_flag,
                                        lam, oh)
            elif solver == "pcg_dual":
                dxc, dxp = _solve_pcg_planar(cam, poses, pts, tb,
                                             robust_flag, lam, cg_iters,
                                             cg_tol)
            else:
                dxc, dxp = _solve_pcg(cam, poses, pts, tb, robust_flag, lam,
                                      cg_iters, cg_tol, oh)
            new_poses = se3.se3_exp(jnp.where(free, dxc, 0.0)) @ poses
            new_pts = pts + dxp
            if solver == "pcg_dual":
                new = _accept_cost_planar(cam, new_poses, new_pts, tb,
                                          robust_flag)
            else:
                new = _accept_cost(cam, new_poses, new_pts, tb, robust_flag,
                                   oh)
            accept = new < cur
            poses_ = jnp.where(accept, new_poses, poses)
            pts_ = jnp.where(accept, new_pts, pts)
            cur_ = jnp.where(accept, new, cur)
            lam_ = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0),
                            1e-9, 1e8)
            return poses_, pts_, lam_, cur_

        poses, pts, lam, cur = jax.lax.cond(
            abort, lambda a: a, step, (poses, pts, lam, cur)
        )
        return (poses, pts, lam, cur), cur

    (poses, pts, _, cost), _ = jax.lax.scan(
        body, (poses, pts, jnp.asarray(1e-4, pts.dtype), cur0), None,
        length=n_iters,
    )
    poses = se3.orthonormalize(poses)
    return poses, pts, cost


# ---------------------------------------------------------------------------
# Incremental (abortable) form: the host owns the LM loop boundary
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("robust", "solver"))
def gba_init(cam: projection.Camera, state: ms.MapState,
             inv_level_sigma2: jax.Array, robust: bool = False,
             fixed_mask: jax.Array | None = None, solver: str = "dense"):
    """Snapshot the problem tables + initial cost for an incremental GBA.

    Returns (tables, (poses, pts, lam, cost)) — the carry threaded through
    `gba_iterate` calls. Splitting the LM loop into per-iteration enqueues
    gives `mbStopGBA` parity at the DEVICE-TIME level: the reference checks
    the stop flag between LM iterations (`src/Optimizer.cc:517-518`,
    `src/LoopClosing.cc:604-631`); here an aborted job simply stops issuing
    iteration programs, so the remaining iterations' device work
    never serializes with tracking."""
    if solver == "pcg_dual":
        # reference scale: flat-lane planar tables (no (P,O,·,·) gather)
        tb = build_planar_tables(state, jnp.asarray(inv_level_sigma2),
                                 fixed_mask)
        cur0 = _accept_cost_planar(cam, state.kf_pose, state.pt_pos, tb,
                                   jnp.asarray(robust))
    else:
        tb = build_tables(state, jnp.asarray(inv_level_sigma2), fixed_mask)
        # gather-path cost (oh=None): one pass per job; the (P,O,K)
        # one-hot never materializes here
        cur0 = _accept_cost(cam, state.kf_pose, state.pt_pos, tb,
                            jnp.asarray(robust), None)
    lam0 = jnp.asarray(1e-4, state.pt_pos.dtype)
    # final carry element: small-gain streak counter (device-side early
    # stop, so the host never fetches to decide)
    return tb, (state.kf_pose, state.pt_pos, lam0, cur0,
                jnp.asarray(0, jnp.int32))


@partial(jax.jit, static_argnames=("robust", "solver", "cg_iters"))
def gba_iterate(cam: projection.Camera, tb, poses, pts, lam,
                cur, small, robust: bool = False, solver: str = "dense",
                cg_iters: int = 100, cg_tol: float = 1e-3,
                rtol: float = 1e-5):
    """ONE damped LM iteration of the full-map BA (same accept/damping
    schedule as `full_bundle_adjustment`'s scan body). The (P,O,K) one-hot
    is rebuilt inside the program (a compare+cast over lanes — cheaper than
    keeping a quarter-GB tensor resident between enqueues).

    `small` counts consecutive < rtol-gain steps; once it reaches 2 the
    program passes the carry through untouched — device-side convergence
    (the host never fetches)."""
    K = poses.shape[0]
    robust_flag = jnp.asarray(robust)

    def step(args):
        poses, pts, lam, cur, small = args
        oh = _onehot_po(tb, K) if solver != "pcg_dual" else None
        free = tb.cam_free[:, None]
        if solver == "dense":
            dxc, dxp = _solve_dense(cam, poses, pts, tb, robust_flag, lam,
                                    oh)
        elif solver == "pcg_dual":
            dxc, dxp = _solve_pcg_planar(cam, poses, pts, tb, robust_flag,
                                         lam, cg_iters, cg_tol)
        else:
            dxc, dxp = _solve_pcg(cam, poses, pts, tb, robust_flag, lam,
                                  cg_iters, cg_tol, oh)
        new_poses = se3.se3_exp(jnp.where(free, dxc, 0.0)) @ poses
        new_pts = pts + dxp
        if solver == "pcg_dual":
            new = _accept_cost_planar(cam, new_poses, new_pts, tb,
                                      robust_flag)
        else:
            new = _accept_cost(cam, new_poses, new_pts, tb, robust_flag, oh)
        accept = new < cur
        # small gains count only on ACCEPTED steps (a rejection adapts
        # lambda and retries; see local_ba._run_phase)
        gain_small = accept & ((cur - new) < rtol * cur)
        small_ = jnp.where(gain_small, small + 1,
                           jnp.where(accept, 0, small))
        poses_ = jnp.where(accept, new_poses, poses)
        pts_ = jnp.where(accept, new_pts, pts)
        cur_ = jnp.where(accept, new, cur)
        lam_ = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e8)
        return poses_, pts_, lam_, cur_, small_

    return jax.lax.cond(small >= 2, lambda a: a, step,
                        (poses, pts, lam, cur, small))
