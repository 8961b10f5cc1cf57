"""Sim3 pose-graph (essential graph) optimization for loop correction.

`Optimizer::OptimizeEssentialGraph` parity (`src/Optimizer.cc:781-1062`,
SURVEY.md §2.1): vertices are per-keyframe Sim3 world->camera transforms
(scale 1 except loop-corrected KFs); edges are (a) the new loop links,
(b) spanning-tree edges, (c) previous loop edges, (d) covisibility edges
with weight >= 100 (`:806`); the loop KF is held fixed; 20 LM iterations
(`:1003`); afterwards poses are recovered as SE3 with translation/scale
(`:1012-1027`) and map points corrected through their reference KF
(`:1031-1060`).

Design: edges carry a measured relative Sim3; residual r =
sim3_log(S_meas * exp(xi_i) S_i * (exp(xi_j) S_j)^-1) linearized by forward-
mode autodiff at xi=0 (batched over all edges), normal equations assembled
densely over (K,7) variables and solved with Cholesky — the essential graph
of a few hundred KFs fits comfortably as a dense problem.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from . import lm as lm_mod


class PoseGraphProblem(NamedTuple):
    S_init: jax.Array  # (K,4,4) initial Sim3 (sR|t) world->camera
    fixed: jax.Array  # (K,) bool
    valid: jax.Array  # (K,) bool
    edge_i: jax.Array  # (E,) i32
    edge_j: jax.Array  # (E,) i32
    edge_meas: jax.Array  # (E,4,4) measured S_ij = S_i S_j^-1
    edge_valid: jax.Array  # (E,)
    edge_weight: jax.Array  # (E,) information scale (1.0 default)


def _edge_residual(S_i, S_j, S_meas, xi_i, xi_j):
    Si = se3.sim3_exp(xi_i) @ S_i
    Sj = se3.sim3_exp(xi_j) @ S_j
    rel = Si @ se3.sim3_inv(Sj)
    return se3.sim3_log(S_meas @ se3.sim3_inv(rel))


def _edge_onehots(prob: PoseGraphProblem, K: int):
    """(E,K) one-hot incidence of each edge's endpoints (f32). Endpoint
    selection and Hessian assembly run as contractions against these —
    row gathers and (K,K,7,7) scatter-adds are avoided (see
    optim/global_ba._onehot_po)."""
    ids = jnp.arange(K, dtype=jnp.int32)
    oh_i = (prob.edge_i[:, None] == ids).astype(jnp.float32)
    oh_j = (prob.edge_j[:, None] == ids).astype(jnp.float32)
    return oh_i, oh_j


def _select_poses(S, oh):
    K = S.shape[0]
    return jnp.einsum("ek,kf->ef", oh, S.reshape(K, 16),
                      precision=lm_mod.HI).reshape(-1, 4, 4)


def _linearize(S, prob: PoseGraphProblem, oh_i, oh_j):
    """Residuals (E,7) and Jacobians (E,7,7)x2 at xi=0 for all edges."""
    Si = _select_poses(S, oh_i)
    Sj = _select_poses(S, oh_j)
    z7 = jnp.zeros(7, S.dtype)

    def res_fn(xi_i, xi_j, a, b, m):
        return _edge_residual(a, b, m, xi_i, xi_j)

    r = jax.vmap(lambda a, b, m: res_fn(z7, z7, a, b, m))(Si, Sj, prob.edge_meas)
    Ji = jax.vmap(
        lambda a, b, m: jax.jacfwd(lambda x: res_fn(x, z7, a, b, m))(z7)
    )(Si, Sj, prob.edge_meas)
    Jj = jax.vmap(
        lambda a, b, m: jax.jacfwd(lambda x: res_fn(z7, x, a, b, m))(z7)
    )(Si, Sj, prob.edge_meas)
    return r, Ji, Jj


def _residuals_only(S, prob: PoseGraphProblem, oh_i, oh_j):
    Si = _select_poses(S, oh_i)
    Sj = _select_poses(S, oh_j)
    z7 = jnp.zeros(7, S.dtype)
    return jax.vmap(lambda a, b, m: _edge_residual(a, b, m, z7, z7))(
        Si, Sj, prob.edge_meas)


def optimize_pose_graph(prob: PoseGraphProblem, n_iters: int = 20,
                        solver: str = "dense", cg_iters: int = 100,
                        cg_tol: float = 1e-6):
    """Run damped Gauss-Newton over the pose graph. Returns (S_opt (K,4,4),
    final chi2).

    solver="dense": the (7K,7K) normal system assembled by incidence
    contraction and solved by Cholesky — `linalg.solve` lowers
    to partial-pivot LU, which the SPD system does not need.

    solver="cg": reference-scale path (K >= ~512). The dense assembly is
    O(E·K²) flops and O(K²·49) memory; the CG form keeps per-edge 7x7
    blocks and runs matvecs through the (E,K) incidence (O(E·K) per
    matvec), preconditioned by the block diagonal."""
    K = prob.S_init.shape[0]
    free = prob.valid & ~prob.fixed
    oh_i, oh_j = _edge_onehots(prob, K)
    if solver == "cg":
        return _optimize_pose_graph_cg(prob, n_iters, cg_iters, cg_tol,
                                       free, oh_i, oh_j)

    def chi2_of(S):
        r = _residuals_only(S, prob, oh_i, oh_j)
        return jnp.sum(
            jnp.where(prob.edge_valid, prob.edge_weight * jnp.sum(r * r, -1), 0.0)
        )

    def step(S, lam):
        r, Ji, Jj = _linearize(S, prob, oh_i, oh_j)
        w = jnp.where(prob.edge_valid, prob.edge_weight, 0.0)
        cur = jnp.sum(w * jnp.sum(r * r, -1))
        # assemble dense H (K*7, K*7) and g (K*7) by incidence contraction
        # (the (K,K,7,7) scatter-add form serialized ~50k updates/iter)
        Hii = jnp.einsum("eri,e,erj->eij", Ji, w, Ji, precision=lm_mod.HI)
        Hjj = jnp.einsum("eri,e,erj->eij", Jj, w, Jj, precision=lm_mod.HI)
        Hij = jnp.einsum("eri,e,erj->eij", Ji, w, Jj, precision=lm_mod.HI)
        gi = -jnp.einsum("eri,e,er->ei", Ji, w, r, precision=lm_mod.HI)
        gj = -jnp.einsum("eri,e,er->ei", Jj, w, r, precision=lm_mod.HI)
        H = (jnp.einsum("ea,eb,eij->abij", oh_i, oh_i, Hii,
                        precision=lm_mod.HI)
             + jnp.einsum("ea,eb,eij->abij", oh_j, oh_j, Hjj,
                          precision=lm_mod.HI)
             + jnp.einsum("ea,eb,eij->abij", oh_i, oh_j, Hij,
                          precision=lm_mod.HI)
             + jnp.einsum("ea,eb,eji->abij", oh_i, oh_j, Hij,
                          precision=lm_mod.HI).transpose(1, 0, 2, 3))
        g = (jnp.einsum("ek,ei->ki", oh_i, gi, precision=lm_mod.HI)
             + jnp.einsum("ek,ei->ki", oh_j, gj, precision=lm_mod.HI))
        Hf = H.transpose(0, 2, 1, 3).reshape(K * 7, K * 7)
        mask = jnp.repeat(free, 7)
        Hf = jnp.where(mask[:, None] & mask[None, :], Hf, 0.0)
        Hf = Hf + jnp.diag(jnp.where(mask, lam, 1.0))
        gf = jnp.where(mask, g.reshape(-1), 0.0)
        # SPD solve (damped GN Hessian + identity rows on fixed vars)
        L = jnp.linalg.cholesky(Hf)
        y = jax.scipy.linalg.solve_triangular(L, gf, lower=True)
        dx = jax.scipy.linalg.solve_triangular(
            L, y, lower=True, trans=1).reshape(K, 7)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        dx = jnp.where(free[:, None], dx, 0.0)
        return se3.sim3_exp(dx) @ S, cur

    def body(carry, _):
        S, lam = carry
        S_new, cur = step(S, lam)
        new = chi2_of(S_new)
        accept = new < cur
        S = jnp.where(accept, S_new, S)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0), 1e-8, 1e8)
        return (S, lam), new

    (S, _), hist = jax.lax.scan(
        body, (prob.S_init, jnp.asarray(1e-6, prob.S_init.dtype)), None,
        length=n_iters,
    )
    # chained f32 sim3_exp products drift off scale x SO(3); project back
    # before the corrected poses are written into the map
    S = se3.sim3_orthonormalize(S)
    return S, chi2_of(S)


def _optimize_pose_graph_cg(prob: PoseGraphProblem, n_iters: int,
                            cg_iters: int, cg_tol: float,
                            free, oh_i, oh_j):
    """Damped GN with a matrix-free PCG inner solve (see
    optimize_pose_graph). Per-edge 7x7 blocks; endpoint selection and
    reduction as (E,K) incidence matmuls; block-Jacobi preconditioner."""
    K = prob.S_init.shape[0]
    dtype = prob.S_init.dtype
    w_e = jnp.where(prob.edge_valid, prob.edge_weight, 0.0)
    free_f = free.astype(dtype)
    eye7 = jnp.eye(7, dtype=dtype)

    def chi2_of(S):
        r = _residuals_only(S, prob, oh_i, oh_j)
        return jnp.sum(w_e * jnp.sum(r * r, -1))

    def step(S, lam):
        r, Ji, Jj = _linearize(S, prob, oh_i, oh_j)
        # zero Jacobians of fixed endpoints (identity handled below)
        fi = jnp.einsum("ek,k->e", oh_i, free_f)[:, None, None]
        fj = jnp.einsum("ek,k->e", oh_j, free_f)[:, None, None]
        Ji = Ji * fi
        Jj = Jj * fj
        cur = jnp.sum(w_e * jnp.sum(r * r, -1))
        Hii = jnp.einsum("eri,e,erj->eij", Ji, w_e, Ji, precision=lm_mod.HI)
        Hjj = jnp.einsum("eri,e,erj->eij", Jj, w_e, Jj, precision=lm_mod.HI)
        Hij = jnp.einsum("eri,e,erj->eij", Ji, w_e, Jj, precision=lm_mod.HI)
        gi = -jnp.einsum("eri,e,er->ei", Ji, w_e, r, precision=lm_mod.HI)
        gj = -jnp.einsum("eri,e,er->ei", Jj, w_e, r, precision=lm_mod.HI)
        g = (jnp.einsum("ek,ei->ki", oh_i, gi, precision=lm_mod.HI)
             + jnp.einsum("ek,ei->ki", oh_j, gj, precision=lm_mod.HI))
        g = jnp.where(free[:, None], g, 0.0)
        # block diagonal (for damping + preconditioner)
        D = (jnp.einsum("ek,eij->kij", oh_i, Hii, precision=lm_mod.HI)
             + jnp.einsum("ek,eij->kij", oh_j, Hjj, precision=lm_mod.HI))
        D = D + eye7 * lam
        D = jnp.where(free[:, None, None], D, eye7[None])
        Minv = jnp.linalg.inv(D)
        Minv = jnp.where(jnp.isfinite(Minv), Minv, eye7[None])

        def matvec(x):  # (K,7)
            x = jnp.where(free[:, None], x, 0.0)
            xi = jnp.einsum("ek,ki->ei", oh_i, x, precision=lm_mod.HI)
            xj = jnp.einsum("ek,ki->ei", oh_j, x, precision=lm_mod.HI)
            yi = (jnp.sum(Hii * xi[:, None, :], -1)
                  + jnp.sum(Hij * xj[:, None, :], -1))
            yj = (jnp.einsum("eij,ei->ej", Hij, xi, precision=lm_mod.HI)
                  + jnp.sum(Hjj * xj[:, None, :], -1))
            y = (jnp.einsum("ek,ei->ki", oh_i, yi, precision=lm_mod.HI)
                 + jnp.einsum("ek,ei->ki", oh_j, yj, precision=lm_mod.HI))
            # off-diagonal pieces above exclude the damping/diag identity:
            # add lam on free rows, identity on fixed rows
            y = y + lam * x
            return jnp.where(free[:, None], y, x)

        def apply_minv(v):
            return jnp.sum(Minv * v[:, None, :], axis=-1)

        x0 = jnp.zeros((K, 7), dtype)
        r0 = g
        p0 = apply_minv(r0)
        rz0 = jnp.sum(r0 * p0)
        gn = jnp.sqrt(jnp.sum(g * g)) + 1e-30

        def cond(c):
            i, x, rr, p, rz = c
            return (i < cg_iters) & (jnp.sqrt(jnp.sum(rr * rr)) / gn
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

        _, dx, _, _, _ = jax.lax.while_loop(cond, body, (0, x0, r0, p0, rz0))
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        dx = jnp.where(free[:, None], dx, 0.0)
        return se3.sim3_exp(dx) @ S, cur

    def body(carry, _):
        S, lam = carry
        S_new, cur = step(S, lam)
        new = chi2_of(S_new)
        accept = new < cur
        S = jnp.where(accept, S_new, S)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0), 1e-8, 1e8)
        return (S, lam), new

    (S, _), _ = jax.lax.scan(
        body, (prob.S_init, jnp.asarray(1e-6, dtype)), None, length=n_iters)
    S = se3.sim3_orthonormalize(S)
    return S, chi2_of(S)


def sim3_to_se3(S: jax.Array) -> jax.Array:
    """Recover SE3 poses: Tiw = [R | t/s] (`src/Optimizer.cc:1012-1027`)."""
    s, R, t = se3.sim3_split(S)
    return se3.rt_to_mat(R, t / s[..., None])


def correct_points(pt_pos: jax.Array, S_old_ref: jax.Array,
                   S_new_ref: jax.Array) -> jax.Array:
    """Move points with their reference KF's Sim3 correction
    (`src/Optimizer.cc:1031-1060`): X' = S_new^-1 ( S_old X ).

    One pose PER point: pt_pos (P,3), S_old_ref/S_new_ref (P,4,4).
    (sim3_transform_points expects a point SET per pose — using it here
    batch-matmuls (P,3) against (P,3,3) into (P,P,3).)"""
    p_cam = jnp.einsum("pij,pj->pi", S_old_ref[..., :3, :3], pt_pos) \
        + S_old_ref[..., :3, 3]
    Sinv = se3.sim3_inv(S_new_ref)
    return jnp.einsum("pij,pj->pi", Sinv[..., :3, :3], p_cam) \
        + Sinv[..., :3, 3]
