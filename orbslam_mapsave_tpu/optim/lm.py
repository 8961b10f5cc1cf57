"""Shared Levenberg-Marquardt machinery for the geometric optimizers.

Replaces g2o's generic graph/LM core (`Thirdparty/g2o/g2o/core/
optimization_algorithm_levenberg.cpp`, `block_solver.hpp`) with explicit
batched residual/Jacobian math: every optimizer in this package builds dense
per-edge Jacobian blocks with `vmap`-style broadcasting, reduces them into
normal equations and runs a damped LM loop under `lax` control flow.

Conventions:
- poses are Tcw (world->camera) 4x4 matrices;
- pose tangent updates are LEFT-multiplicative: T <- se3_exp(xi) @ T with
  xi = [v(3), w(3)] (translation first), mirroring g2o's
  `VertexSE3Expmap::oplusImpl` structure (`types_six_dof_expmap.h:59-77`)
  up to tangent ordering;
- robust loss is Huber applied as IRLS weights, matching the reference's
  `RobustKernelHuber` with delta sqrt(5.991)/sqrt(7.815)
  (`src/Optimizer.cc:85-86,273-274`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# chi-square 95% gates (SURVEY.md appendix A)
CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HI = jax.lax.Precision.HIGHEST


def huber_weight(chi2: jax.Array, delta2: jax.Array) -> jax.Array:
    """IRLS weight for the Huber kernel: 1 inside delta, delta/|e| outside.

    chi2 = squared Mahalanobis residual; delta2 = delta^2.
    """
    r = jnp.sqrt(jnp.maximum(chi2, 1e-20))
    d = jnp.sqrt(delta2)
    return jnp.where(chi2 <= delta2, 1.0, d / r)


def proj_jacobian(p_cam: jax.Array, fx, fy) -> jax.Array:
    """d(pixel)/d(camera point): (...,2,3)."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    zi = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    zi2 = zi * zi
    zero = jnp.zeros_like(x)
    row0 = jnp.stack([fx * zi, zero, -fx * x * zi2], axis=-1)
    row1 = jnp.stack([zero, fy * zi, -fy * y * zi2], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


def point_pose_jacobian(p_cam: jax.Array) -> jax.Array:
    """d(camera point)/d(pose tangent [v,w]) for left-mult update: (...,3,6).

    dP/dv = I, dP/dw = -[P]x.
    """
    from ..geometry.se3 import hat

    eye = jnp.broadcast_to(jnp.eye(3, dtype=p_cam.dtype), p_cam.shape[:-1] + (3, 3))
    return jnp.concatenate([eye, -hat(p_cam)], axis=-1)


def inv3x3(A: jax.Array) -> jax.Array:
    """Closed-form batched 3x3 inverse (adjugate / det) — avoids the
    LU/SVD custom-call path, which runs as a serialized while-loop for
    batches of tiny matrices."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
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
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack([
        jnp.stack([A11, A12, A13], -1),
        jnp.stack([A21, A22, A23], -1),
        jnp.stack([A31, A32, A33], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def solve_spd(H: jax.Array, g: jax.Array, lam: jax.Array,
              refine_steps: int = 2) -> jax.Array:
    """Solve (H + lam*I) dx = g, float32-robust.

    Normal equations square the Jacobian's condition number; in f32 a raw
    Cholesky stalls LM around 1e-3 accuracy (the reference runs g2o in
    double, `Thirdparty/g2o`). Jacobi pre-scaling D^-1/2 H D^-1/2 plus a few
    iterative-refinement passes recovers near-f64 step quality while keeping
    every tensor in f32.
    """
    d = H.shape[-1]
    diag = jnp.diagonal(H, axis1=-2, axis2=-1)
    s = 1.0 / jnp.sqrt(jnp.clip(diag, 1e-12))
    Hs = H * s[..., :, None] * s[..., None, :]
    Hs = Hs + lam * jnp.eye(d, dtype=H.dtype)
    gs = g * s
    cf = jax.scipy.linalg.cho_factor(Hs, lower=True)
    y = jax.scipy.linalg.cho_solve(cf, gs)
    for _ in range(refine_steps):
        r = gs - Hs @ y
        y = y + jax.scipy.linalg.cho_solve(cf, r)
    dx = y * s
    return jnp.where(jnp.isfinite(dx), dx, 0.0)
