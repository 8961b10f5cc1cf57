"""Monocular two-view bootstrap: parallel H / F RANSAC + reconstruction.

`Initializer` parity (`src/Initializer.cc`, SURVEY.md §2.1): the reference
runs homography and fundamental RANSAC in two std::threads
(`Initializer.cc:104-105`); here BOTH model families and ALL their RANSAC
hypotheses evaluate as one batched program. Carried-over behavior:

- 8-point sets, 200 iterations, sigma = 1.0 (`Tracking.cc:820`);
- Hartley normalization (`Normalize`, `Initializer.cc:770-820`);
- H scored by symmetric transfer error, both gates 5.991
  (`CheckHomography`, `Initializer.cc:310-393`); F by epipolar distance,
  gate 3.841 with score cap 5.991 (`CheckFundamental`, `:395-473`);
- model choice RH = SH/(SH+SF) > 0.40 -> H (`Initialize`, `:112-124`);
- F path: E = K^T F K, 4 (R,t) candidates (`DecomposeE`, `:489`), each
  checked by triangulation/cheirality/parallax/reprojection (`CheckRT`,
  `:640-768`) with the reference's winner-uniqueness gates (`ReconstructF`,
  `:475-538`);
- H path: Faugeras SVD decomposition, 8 hypotheses (`ReconstructH`,
  `:540-638`), same CheckRT selection.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..optim import lm as lm_mod

TH_H = 5.991
TH_F = 3.841
TH_SCORE = 5.991


def normalize_points(pts: jax.Array, valid: jax.Array):
    """Hartley normalization with mean absolute deviation (Normalize,
    `Initializer.cc:770-820`). Returns (normalized pts, T (3,3))."""
    w = valid.astype(pts.dtype)
    n = jnp.maximum(w.sum(), 1.0)
    mean = jnp.sum(pts * w[:, None], 0) / n
    d = jnp.abs(pts - mean) * w[:, None]
    mdev = jnp.sum(d, 0) / n
    s = 1.0 / jnp.maximum(mdev, 1e-9)
    pn = (pts - mean) * s
    T = jnp.stack([
        jnp.stack([s[0], jnp.zeros(()), -mean[0] * s[0]]),
        jnp.stack([jnp.zeros(()), s[1], -mean[1] * s[1]]),
        jnp.stack([jnp.zeros(()), jnp.zeros(()), jnp.ones(())]),
    ])
    return pn, T


def _dlt_h(p1: jax.Array, p2: jax.Array, w: jax.Array | None = None):
    """Batched homography DLT: (B,n,2)x2 [+ row weights (B,n)] -> (B,3,3)."""
    B, n, _ = p1.shape
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    r1 = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    if w is not None:
        r1 = r1 * w[..., None]
        r2 = r2 * w[..., None]
    A = jnp.concatenate([r1, r2], axis=1)  # (B,2n,9)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=False)
    h = Vt[..., -1, :]
    return h.reshape(B, 3, 3)


def _dlt_f(p1: jax.Array, p2: jax.Array, w: jax.Array | None = None):
    """Batched 8-point fundamental (+ optional row weights), rank-2 enforced."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = jnp.ones_like(x1)
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], -1
    )  # (B,n,9)
    if w is not None:
        A = A * w[..., None]
    _, _, Vt = jnp.linalg.svd(A, full_matrices=False)
    F = Vt[..., -1, :].reshape(-1, 3, 3)
    U, S, Vt2 = jnp.linalg.svd(F)
    S = S.at[..., 2].set(0.0)
    return U @ (S[..., None] * Vt2)


def _check_h(H21: jax.Array, p1, p2, valid, sigma: float = 1.0):
    """Symmetric transfer score (CheckHomography)."""
    H12 = jnp.linalg.inv(H21 + 1e-12 * jnp.eye(3))
    inv_s2 = 1.0 / (sigma * sigma)

    def transfer(H, a, b):
        ah = jnp.concatenate([a, jnp.ones_like(a[..., :1])], -1)
        bp = jnp.einsum("bij,nj->bni", H, ah, precision=lm_mod.HI)
        w = jnp.where(jnp.abs(bp[..., 2]) < 1e-12, 1e-12, bp[..., 2])
        return jnp.sum((bp[..., :2] / w[..., None] - b[None]) ** 2, -1)

    chi1 = transfer(H12, p2, p1) * inv_s2
    chi2 = transfer(H21, p1, p2) * inv_s2
    inl = valid[None] & (chi1 <= TH_H) & (chi2 <= TH_H)
    score = jnp.sum(
        jnp.where(inl, (TH_H - chi1) + (TH_H - chi2), 0.0), -1
    )
    return score, inl


def _check_f(F21: jax.Array, p1, p2, valid, sigma: float = 1.0):
    """Epipolar distance score (CheckFundamental)."""
    inv_s2 = 1.0 / (sigma * sigma)
    p1h = jnp.concatenate([p1, jnp.ones_like(p1[..., :1])], -1)
    p2h = jnp.concatenate([p2, jnp.ones_like(p2[..., :1])], -1)
    l2 = jnp.einsum("bij,nj->bni", F21, p1h, precision=lm_mod.HI)  # line in im2
    l1 = jnp.einsum("bji,nj->bni", F21, p2h, precision=lm_mod.HI)  # line in im1
    d2 = jnp.sum(l2 * p2h[None], -1) ** 2 / jnp.maximum(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12
    )
    d1 = jnp.sum(l1 * p1h[None], -1) ** 2 / jnp.maximum(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12
    )
    chi1 = d1 * inv_s2
    chi2 = d2 * inv_s2
    inl = valid[None] & (chi1 <= TH_F) & (chi2 <= TH_F)
    score = jnp.sum(
        jnp.where(inl, (TH_SCORE - chi1) + (TH_SCORE - chi2), 0.0), -1
    )
    return score, inl


def triangulate_dlt(P1: jax.Array, P2: jax.Array, uv1: jax.Array, uv2: jax.Array):
    """SVD triangulation (Triangulate, `Initializer.cc:752-768`), batched.

    P1,P2: (3,4) projection matrices; uv: (...,2). Returns (...,3)."""
    A = jnp.stack([
        uv1[..., 0, None] * P1[2] - P1[0],
        uv1[..., 1, None] * P1[2] - P1[1],
        uv2[..., 0, None] * P2[2] - P2[0],
        uv2[..., 1, None] * P2[2] - P2[1],
    ], axis=-2)  # (...,4,4)
    # Inhomogeneous closed-form solve (w=1): 3x3 normal equations instead
    # of the 4x4 homogeneous SVD — batched tiny SVDs run as a serialized
    # Jacobi while-loop. Near-infinite
    # points come out huge and are rejected by the same cheirality/
    # reprojection gates the reference applies after its SVD
    # (`Initializer.cc:640-768`, `LocalMapping.cc:339-407`).
    B = A[..., :3]
    c = A[..., 3]
    M = jnp.sum(B[..., :, :, None] * B[..., :, None, :], axis=-3)  # (...,3,3)
    rhs = -jnp.sum(B * c[..., None], axis=-2)  # (...,3)
    from ..optim.lm import inv3x3

    return jnp.sum(inv3x3(M) * rhs[..., None, :], axis=-1)


def check_rt(R: jax.Array, t: jax.Array, p1: jax.Array, p2: jax.Array,
             valid: jax.Array, K: jax.Array, sigma2: float = 1.0,
             min_parallax_cos: float = 0.99998):
    """`CheckRT` (`Initializer.cc:640-768`): triangulate all matches for a
    candidate (R,t); count 'good' points (finite, parallax, both depths
    positive, both reprojections < 4*sigma2). Returns (n_good, parallax_ok,
    good mask, points3d)."""
    P1 = K @ jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], 1)
    P2 = K @ jnp.concatenate([R, t[:, None]], 1)
    X = triangulate_dlt(P1, P2, p1, p2)  # (N,3)
    finite = jnp.all(jnp.isfinite(X), -1)
    o2 = -R.T @ t
    n1 = X
    n2 = X - o2
    cosp = jnp.sum(n1 * n2, -1) / jnp.maximum(
        jnp.linalg.norm(n1, axis=-1) * jnp.linalg.norm(n2, axis=-1), 1e-12
    )
    z1 = X[..., 2]
    X2 = X @ R.T + t
    z2 = X2[..., 2]
    depth_ok = (z1 > 0) & (z2 > 0)

    def reproj(P, X):
        Xh = jnp.concatenate([X, jnp.ones_like(X[..., :1])], -1)
        x = Xh @ P.T
        w = jnp.where(jnp.abs(x[..., 2]) < 1e-12, 1e-12, x[..., 2])
        return x[..., :2] / w[..., None]

    e1 = jnp.sum((reproj(P1, X) - p1) ** 2, -1)
    e2 = jnp.sum((reproj(P2, X) - p2) ** 2, -1)
    good = (
        valid & finite & depth_ok & (cosp < min_parallax_cos)
        & (e1 < 4.0 * sigma2) & (e2 < 4.0 * sigma2)
    )
    n_good = jnp.sum(good.astype(jnp.int32))
    # parallax of the 50th-best (reference takes min(50, n)-th sorted)
    cosp_good = jnp.where(good, cosp, 1.0)
    sorted_cos = jnp.sort(cosp_good)
    k = jnp.minimum(49, jnp.maximum(n_good - 1, 0))
    med_cos = sorted_cos[k]
    return n_good, med_cos, good, X


def decompose_e(E: jax.Array):
    """4 candidate (R,t) from an essential matrix (`DecomposeE`,
    `Initializer.cc:883-905`)."""
    U, _, Vt = jnp.linalg.svd(E)
    # ensure rotations
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vt
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = U @ W.T @ Vt
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    return [(R1, t), (R1, -t), (R2, t), (R2, -t)]


def decompose_h(H: jax.Array, K: jax.Array):
    """Faugeras 1988 homography decomposition -> 8 (R,t) hypotheses
    (`ReconstructH`, `Initializer.cc:540-638`)."""
    A = jnp.linalg.inv(K) @ H @ K
    U, S, Vt = jnp.linalg.svd(A)
    V = Vt.T
    s = jnp.linalg.det(U) * jnp.linalg.det(V)
    d1, d2, d3 = S[0], S[1], S[2]
    # x1/x3 magnitudes
    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    x1s = jnp.array([1.0, 1.0, -1.0, -1.0]) * aux1
    x3s = jnp.array([1.0, -1.0, 1.0, -1.0]) * aux3
    out = []
    # case d' > 0
    aux_st = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / jnp.maximum((d1 + d3) * d2, 1e-12)
    ct = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    st_signs = jnp.array([1.0, -1.0, -1.0, 1.0]) * aux_st
    for i in range(4):
        Rp = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
        Rp = Rp.at[0, 0].set(ct).at[0, 2].set(-st_signs[i]).at[2, 0].set(st_signs[i]).at[2, 2].set(ct)
        R = s * U @ Rp @ Vt
        tp = jnp.stack([x1s[i], 0.0 * d1, -x3s[i]]) * (d1 - d3)
        t = U @ tp
        out.append((R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)))
    # case d' < 0
    aux_sp = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / jnp.maximum((d1 - d3) * d2, 1e-12)
    cp = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    sp_signs = jnp.array([1.0, -1.0, -1.0, 1.0]) * aux_sp
    for i in range(4):
        Rp = jnp.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]])
        Rp = Rp.at[0, 0].set(cp).at[0, 2].set(sp_signs[i]).at[2, 0].set(sp_signs[i]).at[2, 2].set(-cp)
        R = s * U @ Rp @ Vt
        tp = jnp.stack([x1s[i], 0.0 * d1, x3s[i]]) * (d1 + d3)
        t = U @ tp
        out.append((R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)))
    return out


@partial(jax.jit, static_argnums=(4,))
def initialize_two_view(key: jax.Array, kp1: jax.Array, kp2: jax.Array,
                        valid: jax.Array, n_hyp: int, K: jax.Array,
                        sigma: float = 1.0):
    """Full two-view bootstrap. kp1/kp2: (N,2) matched undistorted pixels
    (row i of kp1 matches row i of kp2); valid: (N,).

    Returns dict(success, R21, t21, points3d (N,3), good (N,), used_h).
    Gates follow `Tracking::MonocularInitialization` +
    `Initializer::Initialize/ReconstructF/ReconstructH`: winner needs >= 50
    good points [minTriangulated], clear uniqueness, parallax.
    """
    N = kp1.shape[0]
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(p.sum(), 1)
    keys = jax.random.split(key, n_hyp)
    idx = jax.vmap(lambda k: jax.random.choice(k, N, (8,), replace=False, p=p))(keys)

    pn1, T1 = normalize_points(kp1, valid)
    pn2, T2 = normalize_points(kp2, valid)
    T2inv = jnp.linalg.inv(T2)

    s1 = pn1[idx]
    s2 = pn2[idx]
    # --- homography family ---
    Hn = _dlt_h(s1, s2)
    H21 = jnp.einsum("ij,bjk,kl->bil", T2inv, Hn, T1, precision=lm_mod.HI)
    h_scores, h_inl = _check_h(H21, kp1, kp2, valid, sigma)
    bi_h = jnp.argmax(h_scores)
    # refine on ALL inliers of the best hypothesis (the reference recomputes
    # the model from the inlier set, `FindHomography` `Initializer.cc:170-176`)
    w_h = h_inl[bi_h].astype(kp1.dtype)
    Hn_r = _dlt_h(pn1[None], pn2[None], w_h[None])
    H21_r = jnp.einsum("ij,bjk,kl->bil", T2inv, Hn_r, T1, precision=lm_mod.HI)
    h_scores_r, h_inl_r = _check_h(H21_r, kp1, kp2, valid, sigma)
    use_r = h_scores_r[0] >= h_scores[bi_h]
    SH = jnp.where(use_r, h_scores_r[0], h_scores[bi_h])
    best_H = jnp.where(use_r, H21_r[0], H21[bi_h])
    best_h_inl = jnp.where(use_r, h_inl_r[0], h_inl[bi_h])
    # --- fundamental family ---
    Fn = _dlt_f(s1, s2)
    F21 = jnp.einsum("ji,bjk,kl->bil", T2, Fn, T1, precision=lm_mod.HI)
    f_scores, f_inl = _check_f(F21, kp1, kp2, valid, sigma)
    bi_f = jnp.argmax(f_scores)
    w_f = f_inl[bi_f].astype(kp1.dtype)
    Fn_r = _dlt_f(pn1[None], pn2[None], w_f[None])
    F21_r = jnp.einsum("ji,bjk,kl->bil", T2, Fn_r, T1, precision=lm_mod.HI)
    f_scores_r, f_inl_r = _check_f(F21_r, kp1, kp2, valid, sigma)
    use_rf = f_scores_r[0] >= f_scores[bi_f]
    SF = jnp.where(use_rf, f_scores_r[0], f_scores[bi_f])
    best_F = jnp.where(use_rf, F21_r[0], F21[bi_f])
    best_f_inl = jnp.where(use_rf, f_inl_r[0], f_inl[bi_f])

    RH = SH / jnp.maximum(SH + SF, 1e-12)
    use_h = RH > 0.40  # Initializer.cc:118

    sigma2 = sigma * sigma
    # --- F path: 4 E-decomposition candidates ---
    E = K.T @ best_F @ K
    cands = decompose_e(E)
    # --- H path: 8 Faugeras candidates ---
    cands_h = decompose_h(best_H, K)

    inl_mask = jnp.where(use_h, best_h_inl, best_f_inl) & valid

    results = []
    for (R, t) in cands + cands_h:
        n_good, med_cos, good, X = check_rt(R, t, kp1, kp2, inl_mask, K, sigma2)
        results.append((n_good, med_cos, good, X, R, t))
    n_goods = jnp.stack([r[0] for r in results])  # (12,)
    is_h_cand = jnp.arange(12) >= 4
    cand_ok = jnp.where(use_h, is_h_cand, ~is_h_cand)
    n_goods = jnp.where(cand_ok, n_goods, 0)
    best_cand = jnp.argmax(n_goods)
    max_good = n_goods[best_cand]
    n_similar = jnp.sum(n_goods > 0.7 * max_good)
    n_inl_total = jnp.sum(inl_mask.astype(jnp.int32))
    min_good = jnp.maximum(
        jnp.asarray(50, jnp.int32),
        (0.9 * n_inl_total).astype(jnp.int32),
    )
    med_coss = jnp.stack([r[1] for r in results])
    goods = jnp.stack([r[2] for r in results])
    Xs = jnp.stack([r[3] for r in results])
    Rs = jnp.stack([r[4] for r in results])
    ts = jnp.stack([r[5] for r in results])
    # parallax > ~1 degree: cos < cos(1deg)=0.99985 (ref: parallax>1.0 deg)
    parallax_ok = med_coss[best_cand] < 0.99985
    success = (max_good >= min_good) & (n_similar == 1) & parallax_ok
    return dict(
        success=success,
        R21=Rs[best_cand],
        t21=ts[best_cand],
        points3d=Xs[best_cand],
        good=goods[best_cand],
        used_h=use_h,
        n_good=max_good,
        sh=SH, sf=SF,
    )
