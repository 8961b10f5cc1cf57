"""Pallas (Triton) GPU kernel: the ENTIRE motion-only pose optimization.

`Optimizer::PoseOptimization` (`src/Optimizer.cc:239-451`) is 4 rounds x 10 LM
iterations over ~2k reprojection edges. As XLA ops this is a chain of 40
dependent iterations, each a handful of small fused kernels plus a 6x6
Cholesky solve over edges that fill no SM: bound by launch latency, not by
bandwidth or arithmetic. This kernel runs the whole schedule in ONE program
(one thread block): the edge arrays are padded to a power of two and read as
block-wide vectors, the 6x6 normal system, its scaled Cholesky solve and the
SE3 exponential update are unrolled scalar math, and the LM loop is an
in-kernel `fori_loop`. Numerics mirror `pose_opt._lm_rounds` (same Huber
schedule, same Jacobi-scaled solve with two iterative-refinement passes,
same acceptance rule and inter-round chi2 reclassification), so the XLA path
is the reference implementation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
POSE_LEN = 16  # flattened 4x4 pose; 12 entries used (power-of-two block)
NUM_WARPS = 8


def padded_edges(m: int) -> int:
    """Edge capacity the kernel runs at: Triton blocks are powers of two."""
    return max(128, 1 << (m - 1).bit_length())


def _sqrt_guard(x):
    return jnp.sqrt(jnp.maximum(x, 1e-20))


def _se3_exp_mul(dx, pose):
    """new_pose = se3_exp(dx) @ pose, all scalars.

    dx: tuple of 6 scalars [v(3), w(3)] — matches `se3.se3_exp` conventions
    (translation first, left-multiplicative update).
    pose: tuple of 12 scalars (r00,r01,r02,tx, r10,...,ty, r20,...,tz).
    """
    v0, v1, v2, w0, w1, w2 = dx
    th2 = w0 * w0 + w1 * w1 + w2 * w2
    small = th2 < 1e-8
    th = jnp.sqrt(jnp.maximum(th2, 0.0))
    safe_th = jnp.where(small, 1.0, th)
    safe_th2 = jnp.where(small, 1.0, th2)
    A = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(safe_th) / safe_th)
    B = jnp.where(small, 0.5 - th2 / 24.0, (1.0 - jnp.cos(safe_th)) / safe_th2)
    C = jnp.where(small, 1.0 / 6.0 - th2 / 120.0,
                  (safe_th - jnp.sin(safe_th)) / (safe_th2 * safe_th))
    # W = hat(w) = [[0,-w2,w1],[w2,0,-w0],[-w1,w0,0]]
    W = ((0.0, -w2, w1), (w2, 0.0, -w0), (-w1, w0, 0.0))
    W2 = tuple(
        tuple(sum(W[i][k] * W[k][j] for k in range(3)) for j in range(3))
        for i in range(3)
    )
    eye = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    R = tuple(
        tuple(eye[i][j] + A * W[i][j] + B * W2[i][j] for j in range(3))
        for i in range(3)
    )
    V = tuple(
        tuple(eye[i][j] + B * W[i][j] + C * W2[i][j] for j in range(3))
        for i in range(3)
    )
    t = tuple(V[i][0] * v0 + V[i][1] * v1 + V[i][2] * v2 for i in range(3))
    # compose: R_new = R @ R_old ; t_new = R @ t_old + t
    ro = ((pose[0], pose[1], pose[2]), (pose[4], pose[5], pose[6]),
          (pose[8], pose[9], pose[10]))
    to = (pose[3], pose[7], pose[11])
    rn = tuple(
        tuple(sum(R[i][k] * ro[k][j] for k in range(3)) for j in range(3))
        for i in range(3)
    )
    tn = tuple(
        sum(R[i][k] * to[k] for k in range(3)) + t[i] for i in range(3)
    )
    return (rn[0][0], rn[0][1], rn[0][2], tn[0],
            rn[1][0], rn[1][1], rn[1][2], tn[1],
            rn[2][0], rn[2][1], rn[2][2], tn[2])


def _solve6(H, g, lam):
    """Jacobi-scaled damped 6x6 Cholesky solve with 2 refinement passes.

    Mirrors `lm.solve_spd` (Jacobi pre-scaling, lam on the scaled diagonal,
    two iterative-refinement passes). H: tuple-of-tuples 6x6 scalars
    (symmetric), g: 6 scalars. Returns 6 scalars.
    """
    s = [1.0 / _sqrt_guard(jnp.maximum(H[i][i], 1e-12)) for i in range(6)]
    Hs = [[H[i][j] * s[i] * s[j] + (lam if i == j else 0.0)
           for j in range(6)] for i in range(6)]
    gs = [g[i] * s[i] for i in range(6)]

    # Cholesky Hs = L L^T; `spd` tracks whether every pre-guard pivot was
    # positive — a non-SPD system must yield dx=0 (solve_spd's NaN->0
    # behavior), not the large finite garbage the sqrt guard would produce
    L = [[None] * 6 for _ in range(6)]
    spd = None
    for i in range(6):
        acc = Hs[i][i]
        for k in range(i):
            acc = acc - L[i][k] * L[i][k]
        spd = (acc > 0.0) if spd is None else (spd & (acc > 0.0))
        L[i][i] = _sqrt_guard(acc)
        inv_d = 1.0 / L[i][i]
        for j in range(i + 1, 6):
            acc = Hs[j][i]
            for k in range(i):
                acc = acc - L[j][k] * L[i][k]
            L[j][i] = acc * inv_d

    def chol_solve(rhs):
        y = [None] * 6
        for i in range(6):
            acc = rhs[i]
            for k in range(i):
                acc = acc - L[i][k] * y[k]
            y[i] = acc / L[i][i]
        x = [None] * 6
        for i in reversed(range(6)):
            acc = y[i]
            for k in range(i + 1, 6):
                acc = acc - L[k][i] * x[k]
            x[i] = acc / L[i][i]
        return x

    y = chol_solve(gs)
    for _ in range(2):
        r = [gs[i] - sum(Hs[i][j] * y[j] for j in range(6)) for i in range(6)]
        dy = chol_solve(r)
        y = [y[i] + dy[i] for i in range(6)]
    dx = [y[i] * s[i] for i in range(6)]
    return [jnp.where(spd & jnp.isfinite(d), d, 0.0) for d in dx]


def _pose_lm_kernel(data_ref, pose_ref, cam_ref, pose_out_ref, inlier_out_ref,
                    *, n_rounds: int, n_iters: int):
    # the edge rows are re-read from the (L1-resident) input on every use
    # instead of being held live across the loop, which keeps register
    # pressure at the intermediates of one normal-system pass
    def row(i):
        return data_ref[i, :]

    fx = cam_ref[0]
    fy = cam_ref[1]
    cx = cam_ref[2]
    cy = cam_ref[3]
    bf = cam_ref[4]

    def residual_core(pose):
        X, Y, Z = row(0), row(1), row(2)
        UR = row(5)
        IS2 = row(6)
        stereo = UR >= 0.0
        r00, r01, r02, tx, r10, r11, r12, ty, r20, r21, r22, tz = pose
        px = r00 * X + r01 * Y + r02 * Z + tx
        py = r10 * X + r11 * Y + r12 * Z + ty
        pz = r20 * X + r21 * Y + r22 * Z + tz
        zsafe = jnp.where(jnp.abs(pz) < 1e-9, 1e-9, pz)
        zi = 1.0 / zsafe
        u_hat = fx * px * zi + cx
        v_hat = fy * py * zi + cy
        ur_hat = u_hat - bf * zi
        e_u = row(3) - u_hat
        e_v = row(4) - v_hat
        e_ur = jnp.where(stereo, UR - ur_hat, 0.0)
        chi2 = (e_u * e_u + e_v * e_v + e_ur * e_ur) * IS2
        behind = pz <= 0.0
        delta2 = jnp.where(stereo, CHI2_STEREO, CHI2_MONO)
        return px, py, pz, zi, e_u, e_v, e_ur, chi2, behind, stereo, delta2

    def robust_cost(chi2, behind, delta2, inlier, robust):
        w_rob = jnp.where(
            robust & (chi2 > delta2), _sqrt_guard(delta2) / _sqrt_guard(chi2),
            1.0)
        val = jnp.where(behind, 1e7, chi2 * w_rob)
        val = jnp.where(jnp.isfinite(val), val, 1e7)
        return w_rob, jnp.sum(jnp.where(inlier, val, 0.0))

    def total_cost(pose, inlier, robust):
        _, _, _, _, _, _, _, chi2, behind, _, delta2 = residual_core(pose)
        return robust_cost(chi2, behind, delta2, inlier, robust)[1]

    def normal_system(pose, inlier, robust):
        (px, py, pz, zi, e_u, e_v, e_ur, chi2, behind, stereo,
         delta2) = residual_core(pose)
        w_rob, total = robust_cost(chi2, behind, delta2, inlier, robust)
        w = jnp.where(inlier & ~behind, row(6) * w_rob, 0.0)
        zi2 = zi * zi
        a = fx * zi
        c = -fx * px * zi2
        b = fy * zi
        d = -fy * py * zi2
        zero = jnp.zeros_like(a)
        # J rows over the 6 tangent dims [v(3), w(3)] (see pose_opt._normal_system)
        Ju = (-a, zero, -c, -(c * py), -(a * pz - c * px), a * py)
        Jv = (zero, -b, -d, -(-b * pz + d * py), d * px, -b * px)
        e3 = c + bf * zi2  # d(uR)/dPz
        Jur_raw = (-a, zero, -e3, -(e3 * py), -(a * pz - e3 * px), a * py)
        Jur = tuple(jnp.where(stereo, j, 0.0) for j in Jur_raw)
        H = [[None] * 6 for _ in range(6)]
        for i in range(6):
            for j in range(i, 6):
                hij = jnp.sum(w * (Ju[i] * Ju[j] + Jv[i] * Jv[j]
                                   + Jur[i] * Jur[j]))
                H[i][j] = hij
                H[j][i] = hij
        g = [-jnp.sum(w * (Ju[i] * e_u + Jv[i] * e_v + Jur[i] * e_ur))
             for i in range(6)]
        return H, g, total

    pose = tuple(pose_ref[i] for i in range(12))
    inlier = row(7) > 0.5

    for rnd in range(n_rounds):
        robust = rnd < 2  # kernels dropped from round 2 (Optimizer.cc:434-437)

        def iter_body(_, carry, robust=robust, inlier=inlier):
            pose = carry[:12]
            lam = carry[12]
            H, g, chi2 = normal_system(pose, inlier, robust)
            dx = _solve6(H, g, lam)
            new_pose = _se3_exp_mul(tuple(dx), pose)
            new_chi2 = total_cost(new_pose, inlier, robust)
            accept = new_chi2 < chi2
            pose = tuple(jnp.where(accept, n, o)
                         for n, o in zip(new_pose, pose))
            lam = jnp.where(accept, lam * 0.5, lam * 4.0)
            lam = jnp.minimum(jnp.maximum(lam, 1e-10), 1e6)
            return pose + (lam,)

        carry = pose + (jnp.float32(1e-4),)
        carry = jax.lax.fori_loop(0, n_iters, iter_body, carry)
        pose = carry[:12]
        # inter-round reclassification against raw chi2 (Optimizer.cc:396-430)
        _, _, _, _, _, _, _, chi2, behind, _, delta2 = residual_core(pose)
        inlier = (row(7) > 0.5) & (chi2 <= delta2) & ~behind

    # the 12 pose scalars leave as one vector store (no scalar memory)
    idx = jax.lax.broadcasted_iota(jnp.int32, (POSE_LEN,), 0)
    out = jnp.where(idx == 15, 1.0, 0.0)
    for i in range(12):
        out = jnp.where(idx == i, pose[i], out)
    pose_out_ref[...] = out
    inlier_out_ref[...] = inlier.astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("n_rounds", "n_iters",
                                             "interpret"))
def pose_optimization_pallas(cam, pose0_cw, obs, n_rounds: int = 4,
                             n_iters: int = 10, interpret: bool = False):
    """Single-kernel device path for `pose_opt.pose_optimization`.

    obs: `pose_opt.PoseObs`. Returns (pose_cw (4,4), inlier (M,) bool,
    n_inliers). Pads the edge set to `padded_edges(M)` invalid edges.
    `interpret` runs the kernel through the Pallas interpreter (tests).
    """
    from ..geometry import se3

    M = obs.uv.shape[0]
    Mp = padded_edges(M)

    def padv(x, fill=0.0):
        return jnp.pad(x.astype(jnp.float32), (0, Mp - M),
                       constant_values=fill)

    data = jnp.stack([
        padv(obs.pt_w[:, 0]), padv(obs.pt_w[:, 1]), padv(obs.pt_w[:, 2]),
        padv(obs.uv[:, 0]), padv(obs.uv[:, 1]), padv(obs.ur, fill=-1.0),
        padv(obs.inv_sigma2), padv(obs.valid.astype(jnp.float32)),
    ])  # (8, Mp): X Y Z U V UR IS2 VALID
    pose_flat = jnp.pad(pose0_cw[:3].reshape(-1).astype(jnp.float32),
                        (0, POSE_LEN - 12))
    # camera scalars padded to a power-of-two block
    cam_vec = jnp.asarray(
        [cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, 0.0, 0.0, 0.0], jnp.float32)

    kern = functools.partial(_pose_lm_kernel, n_rounds=n_rounds,
                             n_iters=n_iters)
    pose_out, inlier_out = pl.pallas_call(
        kern,
        out_shape=(
            jax.ShapeDtypeStruct((POSE_LEN,), jnp.float32),
            jax.ShapeDtypeStruct((Mp,), jnp.float32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        name="pose_lm",
        interpret=interpret,
    )(data, pose_flat, cam_vec)

    pose = pose_out.reshape(4, 4)
    pose = se3.orthonormalize(pose)
    inlier = inlier_out[:M] > 0.5
    return pose, inlier, jnp.sum(inlier.astype(jnp.int32))
