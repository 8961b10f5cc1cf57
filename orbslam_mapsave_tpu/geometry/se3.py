"""SO3 / SE3 / Sim3 Lie-group operations as pure JAX functions.

Array-native replacement for the reference's g2o types
(`Thirdparty/g2o/g2o/types/se3quat.h:41`, `sim3.h`,
`types_six_dof_expmap.h:59`, `types_seven_dof_expmap.h:48`): instead of C++
vertex classes with quaternion storage, poses are plain arrays — rotations as
3x3 matrices, transforms as 4x4 homogeneous matrices — and the exp/log maps are
vectorizable pure functions usable under `jit`/`vmap`/`grad`.

All functions broadcast over leading batch dimensions and are Taylor-guarded
near theta=0 so they are safe under autodiff.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jax.Array) -> jax.Array:
    """so3 hat operator: (...,3) -> (...,3,3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jax.Array) -> jax.Array:
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sinc(theta2: jax.Array) -> jax.Array:
    """sin(t)/t with Taylor guard, given t^2."""
    theta = jnp.sqrt(jnp.maximum(theta2, 0.0))
    small = theta2 < _EPS
    safe = jnp.where(small, 1.0, theta)
    return jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(safe) / safe)


def _cosc(theta2: jax.Array) -> jax.Array:
    """(1-cos(t))/t^2 with Taylor guard, given t^2."""
    small = theta2 < _EPS
    safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(jnp.maximum(safe, 0.0))
    return jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / safe)


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation matrix."""
    theta2 = jnp.sum(w * w, axis=-1)
    W = hat(w)
    W2 = W @ W
    A = _sinc(theta2)[..., None, None]
    B = _cosc(theta2)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A * W + B * W2


def so3_log(R: jax.Array) -> jax.Array:
    """Rotation matrix (...,3,3) -> axis-angle (...,3).

    Handles theta near 0 (Taylor) and theta near pi (diagonal extraction).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # sin(theta) from the skew part: well conditioned near both 0 and pi
    # (arccos of the trace alone loses ~sqrt(eps) digits near pi).
    skew = vee(R - jnp.swapaxes(R, -1, -2))
    sin_t = 0.5 * jnp.linalg.norm(skew, axis=-1)
    theta = jnp.arctan2(sin_t, cos_t)
    generic_scale = jnp.where(
        theta < 1e-5,
        0.5 + theta * theta / 12.0,  # Taylor of theta/(2 sin theta)
        theta / jnp.where(sin_t < 1e-10, 1.0, 2.0 * sin_t),
    )
    w_generic = generic_scale[..., None] * skew
    # Near-pi branch: axis from largest diagonal of (R + I)/2
    S = (R + jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)) * 0.5
    diag = jnp.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], axis=-1)
    k = jnp.argmax(diag, axis=-1)
    col = jnp.take_along_axis(S, k[..., None, None].repeat(3, axis=-2), axis=-1)[..., 0]
    axis = col / jnp.linalg.norm(col, axis=-1, keepdims=True).clip(1e-12)
    # Fix sign so that vee(R - R^T) agrees with axis (vee ~ 2 sin t * axis >= 0 near pi is ~0;
    # use the off-diagonal sign test instead):
    sgn_ref = vee(R - jnp.swapaxes(R, -1, -2))
    dot = jnp.sum(sgn_ref * axis, axis=-1, keepdims=True)
    axis = jnp.where(dot < 0, -axis, axis)
    w_pi = theta[..., None] * axis
    use_generic = (sin_t > 1e-6) | (cos_t > 0.0)
    return jnp.where(use_generic[..., None], w_generic, w_pi)


def so3_left_jacobian(w: jax.Array) -> jax.Array:
    """V matrix of SE3 exp: integral of exp(s*hat(w)) ds, (...,3)->(...,3,3)."""
    theta2 = jnp.sum(w * w, axis=-1)
    W = hat(w)
    W2 = W @ W
    B = _cosc(theta2)[..., None, None]
    # C = (theta - sin theta)/theta^3 guarded
    small = theta2 < _EPS
    safe2 = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(safe2)
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (safe2 * theta))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + B * W + C[..., None, None] * W2


def so3_left_jacobian_inv(w: jax.Array) -> jax.Array:
    """Inverse of the left Jacobian, analytic form."""
    theta2 = jnp.sum(w * w, axis=-1)
    W = hat(w)
    W2 = W @ W
    small = theta2 < _EPS
    safe2 = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(safe2)
    half = theta * 0.5
    cot_coeff = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.sin(jnp.where(small, 1.0, half))) / safe2,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + cot_coeff[..., None, None] * W2


def se3_exp(xi: jax.Array) -> jax.Array:
    """se3 tangent (...,6) [upsilon(trans), omega(rot)] -> (...,4,4) matrix.

    Convention matches g2o `SE3Quat::exp` ordering used by the reference's BA
    updates (translation first is OUR convention; documented here once).
    """
    v, w = xi[..., :3], xi[..., 3:6]
    R = so3_exp(w)
    V = so3_left_jacobian(w)
    t = (V @ v[..., None])[..., 0]
    return rt_to_mat(R, t)


def se3_log(T: jax.Array) -> jax.Array:
    """(...,4,4) -> (...,6) [upsilon, omega]."""
    R, t = mat_to_rt(T)
    w = so3_log(R)
    Vinv = so3_left_jacobian_inv(w)
    v = (Vinv @ t[..., None])[..., 0]
    return jnp.concatenate([v, w], axis=-1)


def rt_to_mat(R: jax.Array, t: jax.Array) -> jax.Array:
    """(...,3,3),(...,3) -> (...,4,4) homogeneous transform."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.zeros(batch + (1, 4), dtype=R.dtype).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def mat_to_rt(T: jax.Array) -> tuple[jax.Array, jax.Array]:
    return T[..., :3, :3], T[..., :3, 3]


def orthonormalize(T: jax.Array, iters: int = 3) -> jax.Array:
    """Project the rotation block of (...,4,4) back onto SO(3).

    Newton iteration for the polar factor, R <- R(3I - R^T R)/2 — pure
    matmuls (no SVD custom call), quadratically convergent for
    near-orthogonal R. Needed because the tracker chains hundreds of f32
    4x4 products per frame (LM updates, velocity model); the resulting
    drift off SO(3) is INVISIBLE to reprojection error at first but is
    amplified geometrically by the constant-velocity feedback loop
    (vel = T_k T_{k-1}^-1 with a transpose-based inverse doubles the
    symmetric error each frame) — measured ~x1.5/frame growth that
    collapsed tracking after ~18 frames. The reference never hits this
    because g2o stores rotations as unit quaternions renormalized on every
    update (`Thirdparty/g2o/g2o/types/se3quat.h:41`).
    """
    R = T[..., :3, :3]
    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), R.shape)
    for _ in range(iters):
        R = R @ (1.5 * eye3 - 0.5 * jnp.swapaxes(R, -1, -2) @ R)
    return rt_to_mat(R, T[..., :3, 3])


def sim3_orthonormalize(S: jax.Array, iters: int = 3) -> jax.Array:
    """Project the sR block of a (...,4,4) Sim3 back onto scale x SO(3).

    Scale recovered as det(sR)^(1/3) (exact for s*R in SO(3)), rotation by
    the same Newton polar iteration as `orthonormalize`. Same rationale:
    chained f32 sim3_exp products drift off the group.
    """
    M = S[..., :3, :3]
    det = jnp.linalg.det(M)
    s = jnp.cbrt(jnp.maximum(det, 1e-30))[..., None, None]
    R = M / s
    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=S.dtype), R.shape)
    for _ in range(iters):
        R = R @ (1.5 * eye3 - 0.5 * jnp.swapaxes(R, -1, -2) @ R)
    return rt_to_mat((s * R).astype(S.dtype), S[..., :3, 3])


def se3_inv(T: jax.Array) -> jax.Array:
    """Fast inverse of rigid transform."""
    R, t = mat_to_rt(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return rt_to_mat(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply (...,4,4) to points (...,N,3) -> (...,N,3)."""
    R, t = mat_to_rt(T)
    return pts @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def quat_to_rot(q: jax.Array) -> jax.Array:
    """Quaternion (...,4) (x,y,z,w, TUM order) -> rotation matrix (...,3,3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = jnp.where(n > 0, 2.0 / jnp.where(n > 0, n, 1.0), 0.0)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return jnp.stack(
        [
            jnp.stack([1.0 - (yy + zz), xy - wz, xz + wy], axis=-1),
            jnp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], axis=-1),
            jnp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def rot_to_quat(R: jax.Array) -> jax.Array:
    """Rotation matrix -> quaternion (x,y,z,w), w>=0, branch-free (Shepperd).

    Used by the TUM trajectory writer for byte-format parity with the
    reference's `Converter::toQuaternion` output (`src/System.cc:747`).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate constructions, pick the numerically best
    qw = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], axis=-1)
    qw = jnp.sqrt(jnp.maximum(qw, 1e-12)) * 0.5
    # case 0: w largest
    c0 = jnp.stack([(m21 - m12), (m02 - m20), (m10 - m01)], axis=-1) / (4.0 * qw[..., 0:1])
    q0 = jnp.concatenate([c0, qw[..., 0:1]], axis=-1)
    c1 = jnp.stack([(m01 + m10), (m02 + m20)], axis=-1) / (4.0 * qw[..., 1:2])
    q1 = jnp.concatenate([qw[..., 1:2], c1, (m21 - m12)[..., None] / (4.0 * qw[..., 1:2])], axis=-1)
    c2 = jnp.stack([(m01 + m10), (m12 + m21)], axis=-1) / (4.0 * qw[..., 2:3])
    q2 = jnp.concatenate([c2[..., 0:1], qw[..., 2:3], c2[..., 1:2], (m02 - m20)[..., None] / (4.0 * qw[..., 2:3])], axis=-1)
    c3 = jnp.stack([(m02 + m20), (m12 + m21)], axis=-1) / (4.0 * qw[..., 3:4])
    q3 = jnp.concatenate([c3, qw[..., 3:4], (m10 - m01)[..., None] / (4.0 * qw[..., 3:4])], axis=-1)
    cases = jnp.stack([q0, q1, q2, q3], axis=-2)  # (...,4cases,4)
    which = jnp.argmax(jnp.stack([tr, m00, m11, m22], axis=-1), axis=-1)
    q = jnp.take_along_axis(cases, which[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    return jnp.where(q[..., 3:4] < 0, -q, q)


# ---------------------------------------------------------------------------
# Sim3: represented as (...,4,4) matrix with sR in the top-left block,
# mirroring g2o::Sim3 (scale folded into the rotation block) plus explicit
# helpers to split/merge the scale.
# ---------------------------------------------------------------------------


def sim3_make(s: jax.Array, R: jax.Array, t: jax.Array) -> jax.Array:
    """Scale (...,), rotation (...,3,3), translation (...,3) -> (...,4,4) with sR block."""
    return rt_to_mat(s[..., None, None] * R, t)


def sim3_split(S: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """(...,4,4) -> (s, R, t). Scale recovered as det(sR)^(1/3)."""
    sR = S[..., :3, :3]
    s = jnp.cbrt(jnp.linalg.det(sR))
    R = sR / s[..., None, None]
    return s, R, S[..., :3, 3]


def sim3_inv(S: jax.Array) -> jax.Array:
    s, R, t = sim3_split(S)
    Rt = jnp.swapaxes(R, -1, -2)
    sinv = 1.0 / s
    return sim3_make(sinv, Rt, -(sinv[..., None] * (Rt @ t[..., None])[..., 0]))


def sim3_exp(xi: jax.Array) -> jax.Array:
    """sim3 tangent (...,7) [nu(3), omega(3), sigma] -> Sim3 matrix (...,4,4).

    W-matrix formulas per Strasdat's scale-drift-aware SLAM derivation (the
    math behind g2o's `sim3.h`); Taylor-guarded for small theta and sigma.
    """
    nu, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 0.0))
    s = jnp.exp(sigma)
    R = so3_exp(w)
    W = hat(w)
    W2 = W @ W

    small_theta = theta2 < _EPS
    small_sigma = jnp.abs(sigma) < 1e-6
    safe_sigma = jnp.where(small_sigma, 1.0, sigma)
    safe_theta = jnp.where(small_theta, 1.0, theta)
    safe_theta2 = jnp.where(small_theta, 1.0, theta2)

    # C = (s - 1)/sigma
    C = jnp.where(small_sigma, 1.0 + sigma * 0.5, (s - 1.0) / safe_sigma)

    sin_t, cos_t = jnp.sin(safe_theta), jnp.cos(safe_theta)
    a = s * sin_t
    b = s * cos_t
    c = theta2 + sigma * sigma
    safe_c = jnp.where(c < 1e-12, 1.0, c)

    # A: coefficient on W ; B: coefficient on W^2
    A_general = (a * sigma + (1.0 - b) * safe_theta) / (safe_theta * safe_c)
    B_general = (C - ((b - 1.0) * sigma + a * safe_theta) / safe_c) / safe_theta2

    # sigma -> 0 limits
    A_sig0 = _cosc(theta2)  # (1-cos)/theta^2
    B_sig0 = jnp.where(
        small_theta,
        1.0 / 6.0,
        (safe_theta - jnp.sin(safe_theta)) / (safe_theta2 * safe_theta),
    )
    # theta -> 0 limits (sigma finite)
    A_th0 = jnp.where(
        small_sigma, 0.5, ((sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma)
    )
    B_th0 = jnp.where(
        small_sigma,
        1.0 / 6.0,
        (s * (0.5 * sigma * sigma - sigma + 1.0) - 1.0) / (safe_sigma**3),
    )

    A = jnp.where(small_sigma, A_sig0, jnp.where(small_theta, A_th0, A_general))
    B = jnp.where(small_sigma, B_sig0, jnp.where(small_theta, B_th0, B_general))

    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    Wmat = C[..., None, None] * eye + A[..., None, None] * W + B[..., None, None] * W2
    t = (Wmat @ nu[..., None])[..., 0]
    return sim3_make(s, R, t)


def sim3_log(S: jax.Array) -> jax.Array:
    """Sim3 matrix -> tangent (...,7) [nu, omega, sigma]. Inverse of sim3_exp.

    Computes the W matrix from (omega, sigma) and solves W nu = t (3x3 solve).
    """
    s, R, t = sim3_split(S)
    w = so3_log(R)
    sigma = jnp.log(s)
    xi_ws = jnp.concatenate([jnp.zeros_like(w), w, sigma[..., None]], axis=-1)
    # Rebuild W by calling exp machinery with nu = identity columns: cheaper to
    # recompute the closed-form coefficients directly.
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 0.0))
    W = hat(w)
    W2 = W @ W
    small_theta = theta2 < _EPS
    small_sigma = jnp.abs(sigma) < 1e-6
    safe_sigma = jnp.where(small_sigma, 1.0, sigma)
    safe_theta = jnp.where(small_theta, 1.0, theta)
    safe_theta2 = jnp.where(small_theta, 1.0, theta2)
    C = jnp.where(small_sigma, 1.0 + sigma * 0.5, (s - 1.0) / safe_sigma)
    sin_t, cos_t = jnp.sin(safe_theta), jnp.cos(safe_theta)
    a_ = s * sin_t
    b_ = s * cos_t
    c_ = theta2 + sigma * sigma
    safe_c = jnp.where(c_ < 1e-12, 1.0, c_)
    A_general = (a_ * sigma + (1.0 - b_) * safe_theta) / (safe_theta * safe_c)
    B_general = (C - ((b_ - 1.0) * sigma + a_ * safe_theta) / safe_c) / safe_theta2
    A_sig0 = _cosc(theta2)
    B_sig0 = jnp.where(small_theta, 1.0 / 6.0, (safe_theta - jnp.sin(safe_theta)) / (safe_theta2 * safe_theta))
    A_th0 = jnp.where(small_sigma, 0.5, ((sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma))
    B_th0 = jnp.where(small_sigma, 1.0 / 6.0, (s * (0.5 * sigma * sigma - sigma + 1.0) - 1.0) / (safe_sigma**3))
    A = jnp.where(small_sigma, A_sig0, jnp.where(small_theta, A_th0, A_general))
    B = jnp.where(small_sigma, B_sig0, jnp.where(small_theta, B_th0, B_general))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=S.dtype), W.shape)
    Wmat = C[..., None, None] * eye + A[..., None, None] * W + B[..., None, None] * W2
    nu = jnp.linalg.solve(Wmat, t[..., None])[..., 0]
    del xi_ws
    return jnp.concatenate([nu, w, sigma[..., None]], axis=-1)


def sim3_transform_points(S: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply Sim3 (...,4,4) with sR block to points (...,N,3)."""
    sR = S[..., :3, :3]
    t = S[..., :3, 3]
    return pts @ jnp.swapaxes(sR, -1, -2) + t[..., None, :]
