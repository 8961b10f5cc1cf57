"""Vectorized EPnP + RANSAC for relocalization.

`PnPsolver` parity (`src/PnPsolver.cc`, SURVEY.md §2.1): EPnP (Lepetit et
al.) — 4 control points from PCA (`choose_control_points`,
`PnPsolver.cc:378`), barycentric coordinates, the 2n x 12 M system reduced to
M^T M (12x12) eigen-decomposition (`compute_pose:480`), beta cases N=1/2/3
with Gauss-Newton refinement over the L_6x10 system (`gauss_newton:843`),
closed-form R,t recovery (Horn). RANSAC re-designed for the device: ALL
hypotheses are solved as one batch (SURVEY.md §7.3) instead of the
reference's sequential 5-iteration chunks, while keeping its acceptance
gates (P=0.99, minInliers, maxIterations, per-scale chi2 thresholds,
`SetRansacParameters`, `PnPsolver.cc:121-157`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..optim import lm as lm_mod


def _choose_control_points(pts: jax.Array, w: jax.Array):
    """(B,n,3), weights (B,n) -> control points (B,4,3).

    cws[0] = weighted centroid; cws[1..3] = centroid + sqrt(eig/n) * eigvec
    (`choose_control_points`, `PnPsolver.cc:378-410`).
    """
    wn = w / jnp.maximum(jnp.sum(w, -1, keepdims=True), 1e-9)
    c = jnp.einsum("bn,bni->bi", wn, pts, precision=lm_mod.HI)
    d = (pts - c[:, None]) * jnp.sqrt(jnp.maximum(w, 0.0))[..., None]
    n_eff = jnp.maximum(jnp.sum(w, -1), 1e-9)
    cov = jnp.einsum("bni,bnj->bij", d, d, precision=lm_mod.HI) / n_eff[:, None, None]
    evals, evecs = jnp.linalg.eigh(cov)  # ascending
    # descending like OpenCV's SVD ordering
    evals = evals[:, ::-1]
    evecs = evecs[:, :, ::-1]
    scale = jnp.sqrt(jnp.maximum(evals, 1e-12))
    cws_rest = c[:, None, :] + scale[..., None] * jnp.swapaxes(evecs, -1, -2)
    return jnp.concatenate([c[:, None, :], cws_rest], axis=1)  # (B,4,3)


def _barycentric(pts: jax.Array, cws: jax.Array):
    """alphas (B,n,4) with sum=1 (`compute_barycentric_coordinates`)."""
    CC = jnp.swapaxes(cws[:, 1:4] - cws[:, 0:1], -1, -2)  # (B,3,3) columns
    CCinv = jnp.linalg.inv(CC + 1e-12 * jnp.eye(3))
    rel = pts - cws[:, 0:1]
    a123 = jnp.einsum("bij,bnj->bni", CCinv, rel, precision=lm_mod.HI)
    a0 = 1.0 - jnp.sum(a123, -1, keepdims=True)
    return jnp.concatenate([a0, a123], axis=-1)


def _fill_MtM(alphas: jax.Array, uv: jax.Array, w: jax.Array):
    """Build M^T M (B,12,12) directly from normalized pixels uv=(u,v)
    (fu=fv=1, uc=vc=0 — caller normalizes), weights per point."""
    B, n, _ = alphas.shape
    u = uv[..., 0]
    v = uv[..., 1]
    # row_u[j*3: j*3+3] = [a_j, 0, -a_j*u]; row_v = [0, a_j, -a_j*v]
    zeros = jnp.zeros_like(alphas)
    ru = jnp.stack([alphas, zeros, -alphas * u[..., None]], axis=-1)  # (B,n,4,3)
    rv = jnp.stack([zeros, alphas, -alphas * v[..., None]], axis=-1)
    Mu = ru.reshape(B, n, 12)
    Mv = rv.reshape(B, n, 12)
    MtM = jnp.einsum("bni,bn,bnj->bij", Mu, w, Mu, precision=lm_mod.HI) + jnp.einsum(
        "bni,bn,bnj->bij", Mv, w, Mv, precision=lm_mod.HI
    )
    return MtM


_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _compute_L6x10(V: jax.Array):
    """V: (B,4,12) the 4 smallest eigenvectors (each 4 control points x 3).
    L rows over the 6 control-point pairs; columns over the 10 beta products
    [b11,b12,b22,b13,b23,b33,b14,b24,b34,b44] (`compute_L_6x10`,
    `PnPsolver.cc:778-841`)."""
    v = V.reshape(V.shape[0], 4, 4, 3)  # (B,4ev,4cp,3)
    dv = jnp.stack([v[:, :, a] - v[:, :, b] for a, b in _PAIRS], axis=2)
    # dv: (B,4ev,6pair,3)

    def dot(i, j):
        return jnp.sum(dv[:, i] * dv[:, j], -1)  # (B,6)

    cols = [
        dot(0, 0), 2 * dot(0, 1), dot(1, 1), 2 * dot(0, 2), 2 * dot(1, 2),
        dot(2, 2), 2 * dot(0, 3), 2 * dot(1, 3), 2 * dot(2, 3), dot(3, 3),
    ]
    return jnp.stack(cols, axis=-1)  # (B,6,10)


def _compute_rho(cws: jax.Array):
    return jnp.stack(
        [jnp.sum((cws[:, a] - cws[:, b]) ** 2, -1) for a, b in _PAIRS], axis=-1
    )  # (B,6)


def _betas_approx_1(L, rho):
    """N=4 case via columns [0,1,3,6] (`find_betas_approx_1`)."""
    A = L[..., jnp.asarray([0, 1, 3, 6])]
    x = _lstsq4(A, rho)
    b1 = jnp.sqrt(jnp.abs(x[..., 0]))
    sgn = jnp.sign(jnp.where(x[..., 0] == 0, 1.0, x[..., 0]))
    return jnp.stack(
        [b1, x[..., 1] / jnp.maximum(b1, 1e-12) * sgn,
         x[..., 2] / jnp.maximum(b1, 1e-12) * sgn,
         x[..., 3] / jnp.maximum(b1, 1e-12) * sgn], axis=-1
    )


def _betas_approx_2(L, rho):
    """columns [0,1,2] (`find_betas_approx_2`)."""
    A = L[..., jnp.asarray([0, 1, 2])]
    x = _lstsq_small(A, rho)
    b1 = jnp.sqrt(jnp.abs(x[..., 0]))
    b2 = jnp.sqrt(jnp.abs(x[..., 2]))
    b2 = jnp.where(x[..., 1] < 0, -b2, b2)
    b2 = jnp.where(x[..., 0] < 0, -b2, b2)  # flip if b11<0 (both flipped)
    b1 = jnp.abs(b1)
    return jnp.stack([b1, b2, jnp.zeros_like(b1), jnp.zeros_like(b1)], axis=-1)


def _betas_approx_3(L, rho):
    """columns [0,1,2,3,4] (`find_betas_approx_3`)."""
    A = L[..., jnp.asarray([0, 1, 2, 3, 4])]
    x = _lstsq_small(A, rho)
    b1 = jnp.sqrt(jnp.abs(x[..., 0]))
    b2 = jnp.sqrt(jnp.abs(x[..., 2]))
    b2 = jnp.where((x[..., 1] < 0), -b2, b2)
    b2 = jnp.where(x[..., 0] < 0, -b2, b2)
    b3 = x[..., 3] / jnp.maximum(b1, 1e-12)
    return jnp.stack([b1, b2, b3, jnp.zeros_like(b1)], axis=-1)


def _lstsq_small(A, b):
    AtA = jnp.einsum("bri,brj->bij", A, A, precision=lm_mod.HI)
    Atb = jnp.einsum("bri,br->bi", A, b, precision=lm_mod.HI)
    k = AtA.shape[-1]
    return jnp.linalg.solve(AtA + 1e-9 * jnp.eye(k), Atb[..., None])[..., 0]


_lstsq4 = _lstsq_small


def _gauss_newton_betas(L, rho, betas, iters: int = 5):
    """Refine betas (B,4) minimizing ||L b10(b) - rho|| (`gauss_newton`,
    `PnPsolver.cc:843-861`, 5 iterations)."""

    def b10_and_J(b):
        b1, b2, b3, b4 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        b10 = jnp.stack(
            [b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3, b3 * b3,
             b1 * b4, b2 * b4, b3 * b4, b4 * b4], axis=-1
        )
        z = jnp.zeros_like(b1)
        J10 = jnp.stack([
            jnp.stack([2 * b1, z, z, z], -1),
            jnp.stack([b2, b1, z, z], -1),
            jnp.stack([z, 2 * b2, z, z], -1),
            jnp.stack([b3, z, b1, z], -1),
            jnp.stack([z, b3, b2, z], -1),
            jnp.stack([z, z, 2 * b3, z], -1),
            jnp.stack([b4, z, z, b1], -1),
            jnp.stack([z, b4, z, b2], -1),
            jnp.stack([z, z, b4, b3], -1),
            jnp.stack([z, z, z, 2 * b4], -1),
        ], axis=-2)  # (B,10,4)
        return b10, J10

    def body(i, b):
        b10, J10 = b10_and_J(b)
        r = rho - jnp.einsum("bij,bj->bi", L, b10, precision=lm_mod.HI)
        J = jnp.einsum("bij,bjk->bik", L, J10, precision=lm_mod.HI)  # (B,6,4)
        JtJ = jnp.einsum("bri,brj->bij", J, J, precision=lm_mod.HI)
        Jtr = jnp.einsum("bri,br->bi", J, r, precision=lm_mod.HI)
        db = jnp.linalg.solve(JtJ + 1e-9 * jnp.eye(4), Jtr[..., None])[..., 0]
        return b + jnp.where(jnp.isfinite(db), db, 0.0)

    return jax.lax.fori_loop(0, iters, body, betas)


def _pose_from_betas(V, betas, alphas, pts3d, w):
    """Control points in camera frame -> R,t via Horn (`compute_ccs`,
    `estimate_R_and_t`, `PnPsolver.cc:580-650`). Returns (B,4,4), err."""
    ccs = jnp.einsum("bk,bkj->bj", betas, V, precision=lm_mod.HI).reshape(
        betas.shape[0], 4, 3
    )
    pcs = jnp.einsum("bnk,bkj->bnj", alphas, ccs, precision=lm_mod.HI)  # (B,n,3)
    # sign fix: depths must be positive (solve_for_sign)
    flip = jnp.sum(jnp.where(w > 0, pcs[..., 2], 0.0), -1) < 0
    pcs = jnp.where(flip[:, None, None], -pcs, pcs)
    # Horn alignment world pts -> camera pts
    wn = w / jnp.maximum(jnp.sum(w, -1, keepdims=True), 1e-9)
    c_w = jnp.einsum("bn,bni->bi", wn, pts3d, precision=lm_mod.HI)
    c_c = jnp.einsum("bn,bni->bi", wn, pcs, precision=lm_mod.HI)
    P = (pts3d - c_w[:, None]) * w[..., None]
    Q = pcs - c_c[:, None]
    H = jnp.einsum("bni,bnj->bij", P, Q, precision=lm_mod.HI)
    U, S, Vt = jnp.linalg.svd(H)
    d = jnp.linalg.det(jnp.einsum("bij,bjk->bik", jnp.swapaxes(Vt, -1, -2),
                                  jnp.swapaxes(U, -1, -2)))
    D = jnp.stack([jnp.ones_like(d), jnp.ones_like(d), d], -1)
    R = jnp.einsum("bji,bj,bjk->bik", Vt, D, jnp.swapaxes(U, -1, -2),
                   precision=lm_mod.HI)
    t = c_c - jnp.einsum("bij,bj->bi", R, c_w, precision=lm_mod.HI)
    return se3.rt_to_mat(R, t)


def _reproj_err2(pose, pts3d, uv_norm, w):
    pc = se3.transform_points(pose, pts3d)
    z = jnp.where(jnp.abs(pc[..., 2]) < 1e-9, 1e-9, pc[..., 2])
    pr = pc[..., :2] / z[..., None]
    e2 = jnp.sum((pr - uv_norm) ** 2, -1)
    return jnp.sum(jnp.where(w > 0, e2, 0.0), -1) / jnp.maximum(
        jnp.sum(w > 0, -1), 1
    )


def _gn_pose_polish(pose: jax.Array, pts3d: jax.Array, uv_norm: jax.Array,
                    w: jax.Array, iters: int = 3) -> jax.Array:
    """Batched Gauss-Newton refinement of (B,4,4) poses on the normalized
    reprojection residual.

    The reference runs EPnP's linear algebra in double (`PnPsolver.cc` uses
    CvMat doubles throughout); the f32 `eigh(M^T M)` nullspace loses ~1e-1
    tangent accuracy on minimal 4-point sets. A couple of 6-DoF GN steps on
    the actual reprojection objective recovers it without any f64 op, which
    keeps the whole solve in f32."""
    def body(pose, _):
        pc = se3.transform_points(pose, pts3d)  # (B,n,3)
        z = jnp.where(jnp.abs(pc[..., 2]) < 1e-9, 1e-9, pc[..., 2])
        r = uv_norm - pc[..., :2] / z[..., None]  # (B,n,2)
        J_proj = lm_mod.proj_jacobian(pc, 1.0, 1.0)  # (B,n,2,3)
        Jc = -jnp.einsum("bnij,bnjk->bnik", J_proj,
                         lm_mod.point_pose_jacobian(pc))  # (B,n,2,6)
        ww = (w > 0).astype(pose.dtype)
        H = jnp.einsum("bnia,bn,bnic->bac", Jc, ww, Jc, precision=lm_mod.HI)
        g = -jnp.einsum("bnia,bn,bni->ba", Jc, ww, r, precision=lm_mod.HI)
        H = H + 1e-8 * jnp.eye(6, dtype=pose.dtype)
        dx = jnp.linalg.solve(H, g[..., None])[..., 0]
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        new_pose = se3.se3_exp(dx) @ pose
        better = _reproj_err2(new_pose, pts3d, uv_norm, w) < _reproj_err2(
            pose, pts3d, uv_norm, w)
        return jnp.where(better[:, None, None], new_pose, pose), None

    pose, _ = jax.lax.scan(body, pose, None, length=iters)
    return pose


def epnp(pts3d: jax.Array, uv_norm: jax.Array, w: jax.Array) -> jax.Array:
    """Batched EPnP: (B,n,3) world points, (B,n,2) normalized image coords,
    (B,n) weights/mask -> (B,4,4) Tcw. Tries beta cases 1..3 and keeps the
    best by reprojection (`compute_pose`, `PnPsolver.cc:480-532`), then
    polishes with a few Gauss-Newton steps (see `_gn_pose_polish`)."""
    cws = _choose_control_points(pts3d, w)
    alphas = _barycentric(pts3d, cws)
    MtM = _fill_MtM(alphas, uv_norm, w)
    _, evecs = jnp.linalg.eigh(MtM)  # ascending
    V = jnp.swapaxes(evecs[..., :4], -1, -2)  # (B,4,12) smallest first
    L = _compute_L6x10(V)
    rho = _compute_rho(cws)
    poses, errs = [], []
    for approx in (_betas_approx_1, _betas_approx_2, _betas_approx_3):
        b0 = approx(L, rho)
        b = _gauss_newton_betas(L, rho, b0)
        pose = _pose_from_betas(V, b, alphas, pts3d, w)
        poses.append(pose)
        errs.append(_reproj_err2(pose, pts3d, uv_norm, w))
    errs = jnp.stack(errs)  # (3,B)
    poses = jnp.stack(poses)  # (3,B,4,4)
    best = jnp.argmin(errs, axis=0)
    pose = jnp.take_along_axis(
        poses, best[None, :, None, None].repeat(4, -1).repeat(4, -2), axis=0
    )[0]
    return _gn_pose_polish(pose, pts3d, uv_norm, w)


@partial(jax.jit, static_argnums=(5,))
def ransac_pnp(key: jax.Array, pts3d: jax.Array, uv: jax.Array,
               max_err2: jax.Array, valid: jax.Array, n_hyp: int = 300,
               fx: float | jax.Array = 1.0, fy: float | jax.Array = 1.0,
               cx: float | jax.Array = 0.0, cy: float | jax.Array = 0.0,
               min_inliers: int = 10):
    """Batched RANSAC EPnP relocalization.

    Parity with `PnPsolver::iterate` (`PnPsolver.cc:165-260`) + `Refine`
    (`:262-307`): 4-point minimal sets, per-point chi2 gates max_err2
    (sigma-scaled, `SetRansacParameters` `PnPsolver.cc:154-156`), then one
    all-inlier EPnP refinement of the best hypothesis. All `n_hyp`
    hypotheses run as one batch. Returns (pose, inliers, n_inliers, ok).
    """
    M = pts3d.shape[0]
    uv_norm = jnp.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)
    # sample 4 distinct indices per hypothesis among valid points
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(p.sum(), 1)
    keys = jax.random.split(key, n_hyp)
    idx = jax.vmap(
        lambda k: jax.random.choice(k, M, (4,), replace=False, p=p)
    )(keys)  # (B,4)
    h_pts = pts3d[idx]
    h_uv = uv_norm[idx]
    h_w = jnp.ones((n_hyp, 4), pts3d.dtype)
    poses = epnp(h_pts, h_uv, h_w)  # (B,4,4)
    # count inliers per hypothesis
    pcam = jnp.einsum("bij,nj->bni", poses[:, :3, :3], pts3d,
                      precision=lm_mod.HI) + poses[:, None, :3, 3]
    z = jnp.where(jnp.abs(pcam[..., 2]) < 1e-9, 1e-9, pcam[..., 2])
    pr = pcam[..., :2] / z[..., None]
    # error in PIXELS (reference checks against maxError in pixel^2 units)
    e2 = ((pr[..., 0] * fx + cx) - uv[None, :, 0]) ** 2 + (
        (pr[..., 1] * fy + cy) - uv[None, :, 1]
    ) ** 2
    inl = valid[None, :] & (e2 <= max_err2[None, :]) & (pcam[..., 2] > 0)
    counts = jnp.sum(inl.astype(jnp.int32), -1)
    best = jnp.argmax(counts)
    best_inl = inl[best]
    n_best = counts[best]
    # refine on all inliers (single "batch" of 1 with masked weights)
    w_ref = jnp.where(best_inl, 1.0, 0.0)[None]
    pose_ref = epnp(pts3d[None], uv_norm[None], w_ref)[0]
    pcam2 = se3.transform_points(pose_ref, pts3d)
    z2 = jnp.where(jnp.abs(pcam2[..., 2]) < 1e-9, 1e-9, pcam2[..., 2])
    e2r = ((pcam2[..., 0] / z2 * fx + cx) - uv[..., 0]) ** 2 + (
        (pcam2[..., 1] / z2 * fy + cy) - uv[..., 1]
    ) ** 2
    inl_ref = valid & (e2r <= max_err2) & (pcam2[..., 2] > 0)
    n_ref = jnp.sum(inl_ref.astype(jnp.int32))
    use_ref = n_ref >= n_best
    pose_out = jnp.where(use_ref, pose_ref, poses[best])
    inl_out = jnp.where(use_ref, inl_ref, best_inl)
    n_out = jnp.maximum(n_ref, n_best)
    return pose_out, inl_out, n_out, n_out >= min_inliers
