"""Pinhole camera projection / undistortion as batched JAX functions.

Replaces the reference's per-point OpenCV calls:
- keypoint undistortion `Frame::UndistortKeyPoints` (`src/Frame.cc:500-540`)
- frustum check `Frame::isInFrustum` (`src/Frame.cc:387-443`)
- stereo unprojection `Frame::UnprojectStereo` (`src/Frame.cc:782-796`)

All functions take a camera parameter pytree and operate on (N,...) arrays so
the whole frame is processed in one fused XLA program.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Camera(NamedTuple):
    """Intrinsics + distortion, mirroring the camera YAML keys
    (`Examples/ORB_RGBD640x480.yaml:7-46`).

    Fields are PYTHON FLOATS, not device arrays, on purpose: camera
    parameters appear inside every jitted program, and Python floats
    become HLO literals at trace time, where a jit-CLOSED-OVER device
    array would become a captured constant of every program (whether
    that still costs dispatch time on the GPU is unmeasured, ROADMAP
    Queue 3). The same rule holds everywhere: jitted closures may capture python scalars and
    NUMPY arrays (literals), never `jnp` arrays; device-resident tables
    must be ARGUMENTS."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    p1: float
    p2: float
    k3: float
    bf: float  # baseline * fx (stereo/RGB-D); 0 for pure mono
    width: int = 640
    height: int = 480

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, bf=0.0,
               width=640, height=480, dtype=None) -> "Camera":
        del dtype  # kept for call-site compatibility; params are floats
        f = float
        return Camera(f(fx), f(fy), f(cx), f(cy), f(k1), f(k2), f(p1), f(p2),
                      f(k3), f(bf), int(width), int(height))

    @property
    def K(self) -> "np.ndarray":
        import numpy as np

        return np.array([
            [self.fx, 0.0, self.cx],
            [0.0, self.fy, self.cy],
            [0.0, 0.0, 1.0],
        ], np.float32)

    @property
    def has_distortion(self) -> bool:
        # Static check usable at trace time when params are Python floats.
        return True


def distort_normalized(cam: Camera, xn: jax.Array) -> jax.Array:
    """Apply radial-tangential distortion to normalized coords (...,2)."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def undistort_points(cam: Camera, uv: jax.Array, iters: int = 10) -> jax.Array:
    """Undistort pixel keypoints (...,2) -> undistorted pixel coords (...,2).

    Fixed-point iteration (the method inside cv::undistortPoints), run for a
    static number of iterations so it jits to straight-line code.
    """
    x0 = (uv[..., 0] - cam.cx) / cam.fx
    y0 = (uv[..., 1] - cam.cy) / cam.fy
    xn0 = jnp.stack([x0, y0], axis=-1)
    xn = xn0

    def body(_, xn):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        return jnp.stack(
            [(xn0[..., 0] - dx) / radial, (xn0[..., 1] - dy) / radial], axis=-1
        )

    xn = jax.lax.fori_loop(0, iters, body, xn)
    return jnp.stack(
        [xn[..., 0] * cam.fx + cam.cx, xn[..., 1] * cam.fy + cam.cy], axis=-1
    )


def project(cam: Camera, pts_cam: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Camera-frame 3D points (...,3) -> (pixel uv (...,2), depth (...,)).

    Projects WITHOUT distortion — the pipeline matches against undistorted
    keypoints, exactly like the reference (`Frame.cc:387-443` projects with
    plain K against `mvKeysUn`).
    """
    z = pts_cam[..., 2]
    zsafe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pts_cam[..., 0] / zsafe + cam.cx
    v = cam.fy * pts_cam[..., 1] / zsafe + cam.cy
    return jnp.stack([u, v], axis=-1), z


def project_stereo(cam: Camera, pts_cam: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Like project, plus the right-image u coordinate (u - bf/z)."""
    uv, z = project(cam, pts_cam)
    zsafe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    ur = uv[..., 0] - cam.bf / zsafe
    return jnp.concatenate([uv, ur[..., None]], axis=-1), z


def backproject(cam: Camera, uv: jax.Array, depth: jax.Array) -> jax.Array:
    """Undistorted pixels (...,2) + depth (...,) -> camera-frame 3D (...,3).

    Mirrors `Frame::UnprojectStereo` (`src/Frame.cc:782-796`).
    """
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return jnp.stack([x, y, depth], axis=-1)


def in_image(cam: Camera, uv: jax.Array, min_x: jax.Array, max_x: jax.Array,
             min_y: jax.Array, max_y: jax.Array) -> jax.Array:
    """Bounds check against the undistorted-image bounds (Frame.cc:417-421)."""
    return (
        (uv[..., 0] >= min_x)
        & (uv[..., 0] < max_x)
        & (uv[..., 1] >= min_y)
        & (uv[..., 1] < max_y)
    )


def compute_image_bounds(cam: Camera) -> "np.ndarray":
    """Undistorted image bounds [min_x, max_x, min_y, max_y] as a NUMPY
    array, computed ENTIRELY on host. Two reasons: the result is captured
    as a jit-closure constant everywhere (device arrays there are
    forbidden, see Camera docstring), and running `undistort_points`
    eagerly would execute a `fori_loop` whose body captures a concrete
    device array — the very poison pattern, fired from every constructor.

    Mirrors `Frame::ComputeImageBounds` (`src/Frame.cc:542-572`): undistort
    the four corners and take min/max.
    """
    import numpy as np

    corners = np.array(
        [[0.0, 0.0], [cam.width, 0.0], [0.0, cam.height],
         [cam.width, cam.height]], np.float64,
    )
    # the fixed-point iteration of undistort_points, in numpy
    x0 = (corners[:, 0] - cam.cx) / cam.fx
    y0 = (corners[:, 1] - cam.cy) / cam.fy
    x, y = x0.copy(), y0.copy()
    for _ in range(10):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    u = x * cam.fx + cam.cx
    v = y * cam.fy + cam.cy
    return np.array(
        [
            min(u[0], u[2]),
            max(u[1], u[3]),
            min(v[0], v[1]),
            max(v[2], v[3]),
        ], np.float32,
    )
