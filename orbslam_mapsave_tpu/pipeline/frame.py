"""Per-frame feature container built from one image (+ optional depth).

`Frame` parity (`src/Frame.cc`, SURVEY.md §2.1): ORB extraction, keypoint
undistortion (`Frame::UndistortKeyPoints`, `src/Frame.cc:522`), RGB-D
pseudo-stereo (`Frame::ComputeStereoFromRGBD`, `src/Frame.cc:759-780`) and
scale-pyramid metadata. The 64x48 feature grid (`Frame::AssignFeaturesToGrid`,
`src/Frame.cc:341`) is NOT materialized: windowed candidate generation is a
dense mask in the matching kernels (`ops/matching.py`), which is the
vectorized equivalent of grid bucketing.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import projection
from ..ops import hamming, orb


class FrameData(NamedTuple):
    timestamp: jax.Array  # ()
    kp_xy_raw: jax.Array  # (N,2) raw pixel coords
    kp_xy: jax.Array  # (N,2) undistorted
    kp_ur: jax.Array  # (N,) right-u (<0 mono)
    kp_depth: jax.Array  # (N,) depth (<=0 none)
    kp_octave: jax.Array  # (N,)
    kp_angle: jax.Array  # (N,) degrees
    kp_response: jax.Array  # (N,)
    desc: jax.Array  # (N,32) u8
    desc_bits: jax.Array  # (N,256) i8 — precomputed for matmul matching
    valid: jax.Array  # (N,)


class FrameBuilder:
    """Closes over static config; produces jitted frame construction."""

    def __init__(self, cam: projection.Camera, spec: orb.ORBSpec,
                 th_depth_m: float | None = None):
        self.cam = cam
        self.spec = spec
        # NUMPY on purpose: these are captured by jitted closures all over
        # the pipeline as trace-time literals (see
        # geometry.projection.Camera docstring)
        import numpy as _np

        self.scale_factors = _np.asarray(
            [spec.scale_factor**i for i in range(spec.n_levels)], _np.float32
        )
        self.inv_level_sigma2 = (1.0 / (self.scale_factors**2)).astype(
            _np.float32)
        self.bounds = projection.compute_image_bounds(cam)
        self.th_depth_m = th_depth_m  # close/far split (ThDepth * baseline)

        @jax.jit
        def _build(image, timestamp, depth, mask):
            # inputs arrive in their storage dtype (u8 images, f16 depth:
            # a quarter of the host->device bytes of an f32 pair); all
            # compute runs f32 on device
            image = image.astype(jnp.float32)
            if depth is not None:
                depth = depth.astype(jnp.float32)
            kp = orb.extract(spec, image, mask)
            und = projection.undistort_points(cam, kp["xy"])
            n = kp["xy"].shape[0]
            if depth is not None:
                # sample depth at raw (rounded) keypoint coords, Frame.cc:765-768
                xi = jnp.clip(jnp.round(kp["xy"][:, 0]).astype(jnp.int32), 0,
                              depth.shape[1] - 1)
                yi = jnp.clip(jnp.round(kp["xy"][:, 1]).astype(jnp.int32), 0,
                              depth.shape[0] - 1)
                d = depth[yi, xi]
                has_d = d > 0
                ur = jnp.where(has_d, und[:, 0] - cam.bf / jnp.where(has_d, d, 1.0),
                               -1.0)
                kp_depth = jnp.where(has_d, d, -1.0)
            else:
                ur = jnp.full((n,), -1.0, jnp.float32)
                kp_depth = jnp.full((n,), -1.0, jnp.float32)
            bits = hamming.unpack_bits(kp["desc"])
            return FrameData(
                timestamp=jnp.asarray(timestamp, jnp.float32),
                kp_xy_raw=kp["xy"],
                kp_xy=und,
                kp_ur=ur,
                kp_depth=kp_depth,
                kp_octave=kp["octave"],
                kp_angle=kp["angle_deg"],
                kp_response=kp["response"],
                desc=kp["desc"],
                desc_bits=bits,
                valid=kp["valid"],
            )

        self._build_rgbd = lambda img, t, depth, mask=None: _build(img, t, depth, mask)
        self._build_mono = lambda img, t, mask=None: _build(img, t, None, mask)

        @jax.jit
        def _build_stereo(image_left, image_right, timestamp):
            """Stereo frame: batched L/R extraction (the reference spawns two
            threads, `Frame::Frame` `src/Frame.cc:78-79` — here the pair is a
            batch dimension) + `ComputeStereoMatches` (`src/Frame.cc:584-756`)
            for per-left-keypoint uRight/depth."""
            from ..ops import stereo as stereo_mod

            pair = jnp.stack([image_left.astype(jnp.float32),
                              image_right.astype(jnp.float32)])
            kp = jax.vmap(lambda im: orb.extract(spec, im))(pair)
            kl = jax.tree.map(lambda a: a[0], kp)
            kr = jax.tree.map(lambda a: a[1], kp)
            bits_l = hamming.unpack_bits(kl["desc"])
            bits_r = hamming.unpack_bits(kr["desc"])
            ur, kp_depth = stereo_mod.compute_stereo_matches(
                spec, pair[0], pair[1],
                kl["xy"], kl["octave"], bits_l, kl["valid"],
                kr["xy"], kr["octave"], bits_r, kr["valid"],
                bf=float(cam.bf), fx=float(cam.fx),
            )
            und = projection.undistort_points(cam, kl["xy"])
            return FrameData(
                timestamp=jnp.asarray(timestamp, jnp.float32),
                kp_xy_raw=kl["xy"],
                kp_xy=und,
                kp_ur=ur,
                kp_depth=kp_depth,
                kp_octave=kl["octave"],
                kp_angle=kl["angle_deg"],
                kp_response=kl["response"],
                desc=kl["desc"],
                desc_bits=bits_l,
                valid=kl["valid"],
            )

        self._build_stereo = _build_stereo

    def build(self, image, timestamp, depth=None, mask=None) -> FrameData:
        image = jnp.asarray(image)  # native dtype; converted on device
        if depth is not None:
            return self._build_rgbd(image, timestamp, jnp.asarray(depth), mask)
        return self._build_mono(image, timestamp, mask)

    def build_stereo(self, image_left, image_right, timestamp) -> FrameData:
        return self._build_stereo(jnp.asarray(image_left),
                                  jnp.asarray(image_right), timestamp)
