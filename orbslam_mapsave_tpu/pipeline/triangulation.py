"""New map-point creation by two-view triangulation between keyframes.

`LocalMapping::CreateNewMapPoints` parity (`src/LocalMapping.cc:207-452`):
for each of the current KF's best covisible neighbours (10 stereo / 20
mono, `:210-212`): baseline gate (`:243-261`), fundamental-matrix epipolar
search (`ComputeF12` `:536-553` + `SearchForTriangulation`), then per match:
parallax test, SVD triangulation (or stereo depth when better conditioned,
`:322-352`), cheirality both views, reprojection chi2 (5.991 mono /
7.8 stereo, `:367-407`), scale-consistency ratio 1.5*ratioFactor
(`:409-435`), and finally MapPoint creation with both observations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry import projection, se3
from ..ops import hamming, matching
from ..optim import lm as lm_mod
from ..slammap import mapstate as ms


def compute_f12(cam: projection.Camera, T1w: jax.Array, T2w: jax.Array):
    """Fundamental matrix between two keyframes: x1^T F12 x2 = 0
    (`LocalMapping::ComputeF12`, `src/LocalMapping.cc:536-553`)."""
    R1w, t1w = se3.mat_to_rt(T1w)
    R2w, t2w = se3.mat_to_rt(T2w)
    R12 = R1w @ R2w.T
    t12 = -(R12 @ t2w) + t1w
    t12x = se3.hat(t12)
    K = cam.K
    Kinv = jnp.linalg.inv(K)
    return Kinv.T @ t12x @ R12 @ Kinv


def make_triangulator(cam: projection.Camera, scale_factors,
                      level_sigma2, n_levels: int,
                      scale_factor: float, is_mono: bool):
    import numpy as np

    # numpy closure constants (trace-time literals; see
    # geometry.projection.Camera docstring) — converted to trace-time
    # literals inside the traced functions
    scale_factors = np.asarray(scale_factors, np.float32)
    level_sigma2 = np.asarray(level_sigma2, np.float32)
    ratio_factor = 1.5 * scale_factor  # LocalMapping.cc:298

    def candidates(state: ms.MapState, kf1, kf2, enabled=True):
        """PURE candidate generation between kf1 (current) and kf2: all the
        matching + geometric gates of `CreateNewMapPoints`
        (`src/LocalMapping.cc:264-449`) with NO state mutation, so it vmaps
        over the neighbour axis. Returns (ok (N,), X (N,3), m2 (N,), pair_ok).
        """
        T1 = state.kf_pose[kf1]
        T2 = state.kf_pose[kf2]
        O1 = se3.se3_inv(T1)[:3, 3]
        O2 = se3.se3_inv(T2)[:3, 3]
        baseline = jnp.linalg.norm(O2 - O1)
        # baseline gate evaluated FIRST so a rejected pair creates nothing
        # (:243-261)
        if is_mono:
            med_depth = _median_scene_depth(state, kf2, cam)
            pair_ok = baseline / jnp.maximum(med_depth, 1e-9) > 0.01
        else:
            pair_ok = baseline > cam.bf / cam.fx  # stereo: > camera baseline

        # candidate features: valid, WITHOUT an associated point (:274 via
        # GetUntrackedFeatures — SearchForTriangulation takes only unmatched)
        un1 = state.kf_kp_valid[kf1] & (state.kf_kp_point[kf1] < 0)
        un2 = state.kf_kp_valid[kf2] & (state.kf_kp_point[kf2] < 0)
        F12 = compute_f12(cam, T1, T2)
        # epipole of camera 1 in image 2 (ORBmatcher.cc:668-675)
        C1in2 = se3.transform_points(T2, O1[None])[0]
        ep_uv, _ = projection.project(cam, C1in2)
        b1 = hamming.unpack_bits(state.kf_desc[kf1])
        b2 = hamming.unpack_bits(state.kf_desc[kf2])
        matches, _ = matching.search_for_triangulation(
            state.kf_kp_xy[kf1], state.kf_kp_octave[kf1], b1, un1,
            state.kf_kp_xy[kf2], state.kf_kp_octave[kf2], b2, un2,
            F12, ep_uv, level_sigma2,
            check_epipole_dist=bool(is_mono),
            angle_1=state.kf_kp_angle[kf1], angle_2=state.kf_kp_angle[kf2],
        )
        ok = matches >= 0
        m2 = jnp.clip(matches, 0)

        xy1 = state.kf_kp_xy[kf1]
        xy2 = state.kf_kp_xy[kf2][m2]
        # rays + parallax (:301-320)
        xn1 = jnp.stack([(xy1[:, 0] - cam.cx) / cam.fx,
                         (xy1[:, 1] - cam.cy) / cam.fy,
                         jnp.ones_like(xy1[:, 0])], -1)
        xn2 = jnp.stack([(xy2[:, 0] - cam.cx) / cam.fx,
                         (xy2[:, 1] - cam.cy) / cam.fy,
                         jnp.ones_like(xy2[:, 0])], -1)
        R1w, t1w = se3.mat_to_rt(T1)
        R2w, t2w = se3.mat_to_rt(T2)
        ray1 = xn1 @ R1w  # = Rwc1 @ xn1
        ray2 = xn2 @ R2w
        cos_rays = jnp.sum(ray1 * ray2, -1) / jnp.maximum(
            jnp.linalg.norm(ray1, axis=-1) * jnp.linalg.norm(ray2, axis=-1),
            1e-12,
        )
        d1 = state.kf_kp_depth[kf1]
        d2 = state.kf_kp_depth[kf2][m2]
        # stereo parallax floors (:305-315)
        cos_stereo1 = jnp.where(
            d1 > 0, jnp.cos(2.0 * jnp.arctan2(cam.bf / cam.fx / 2.0,
                                              jnp.maximum(d1, 1e-6))), 2.0
        )
        cos_stereo2 = jnp.where(
            d2 > 0, jnp.cos(2.0 * jnp.arctan2(cam.bf / cam.fx / 2.0,
                                              jnp.maximum(d2, 1e-6))), 2.0
        )
        cos_stereo = jnp.minimum(cos_stereo1, cos_stereo2)

        # triangulate by SVD when parallax good (:322-337)
        P1 = cam.K @ T1[:3, :4]
        P2 = cam.K @ T2[:3, :4]
        from ..ops.initializer import triangulate_dlt

        X_tri = triangulate_dlt(P1, P2, xy1, xy2)
        # world coords of depth-backprojections
        Twc1 = se3.se3_inv(T1)
        Twc2 = se3.se3_inv(T2)
        X_d1 = se3.transform_points(Twc1, projection.backproject(cam, xy1, d1))
        X_d2 = se3.transform_points(Twc2, projection.backproject(cam, xy2, d2))
        good_parallax = (cos_rays < cos_stereo) & (cos_rays > 0) & (
            cos_rays < 0.9998
        )
        use_d1 = ~good_parallax & (d1 > 0) & (cos_stereo1 < cos_stereo2)
        use_d2 = ~good_parallax & ~use_d1 & (d2 > 0)
        X = jnp.where(good_parallax[:, None], X_tri,
                      jnp.where(use_d1[:, None], X_d1, X_d2))
        ok = ok & (good_parallax | use_d1 | use_d2)

        # cheirality (:339-352)
        pc1 = se3.transform_points(T1, X)
        pc2 = se3.transform_points(T2, X)
        ok = ok & (pc1[:, 2] > 0) & (pc2[:, 2] > 0)

        # reprojection chi2 (:354-407); mono gate 5.991
        uv1_hat, _ = projection.project(cam, pc1)
        uv2_hat, _ = projection.project(cam, pc2)
        ls2 = jnp.asarray(level_sigma2)
        s1 = ls2[jnp.clip(state.kf_kp_octave[kf1], 0, n_levels - 1)]
        s2 = ls2[jnp.clip(state.kf_kp_octave[kf2][m2], 0, n_levels - 1)]
        e1 = jnp.sum((uv1_hat - xy1) ** 2, -1)
        e2 = jnp.sum((uv2_hat - xy2) ** 2, -1)
        ok = ok & (e1 <= 5.991 * s1) & (e2 <= 5.991 * s2)

        # scale consistency (:409-435)
        dist1 = jnp.linalg.norm(X - O1[None], axis=-1)
        dist2 = jnp.linalg.norm(X - O2[None], axis=-1)
        ratio_dist = dist2 / jnp.maximum(dist1, 1e-9)
        sfj = jnp.asarray(scale_factors)
        sf1 = sfj[jnp.clip(state.kf_kp_octave[kf1], 0, n_levels - 1)]
        sf2 = sfj[jnp.clip(state.kf_kp_octave[kf2][m2], 0, n_levels - 1)]
        ratio_oct = sf1 / sf2
        ok = ok & (ratio_dist < ratio_oct * ratio_factor) & (
            ratio_dist * ratio_factor > ratio_oct
        ) & (dist1 > 0) & (dist2 > 0)
        ok = ok & pair_ok & enabled
        return ok, X, m2, pair_ok

    def commit(state: ms.MapState, kf1, kf2_rows, ok, X, m2):
        """Materialize candidate points: allocation + both observations.
        kf2_rows: (N,) the neighbour KF per feature (varying)."""
        state, slots = ms.add_points(state, X, state.kf_desc[kf1], kf1, kf1, ok)
        feat1 = jnp.arange(X.shape[0], dtype=jnp.int32)
        state = ms.add_observations(state, kf1, slots, feat1, ok)
        state = ms.add_observations_rows(state, kf2_rows, slots, m2, ok)
        return state, slots

    def triangulate_core(state: ms.MapState, kf1, kf2, enabled=True):
        """Single-pair create (kept for callers that go one neighbour at a
        time). Returns (state, slots (N,) i32 or -1, pair_ok)."""
        ok, X, m2, pair_ok = candidates(state, kf1, kf2, enabled)
        kf2_rows = jnp.full(X.shape[0], kf2, jnp.int32)
        state, slots = commit(state, kf1, kf2_rows, ok, X, m2)
        return state, slots, pair_ok

    def triangulate_batched(state: ms.MapState, kf1, neigh: jax.Array):
        """All neighbours at once: vmap the pure candidate pass over the
        neighbour axis, keep each feature's FIRST matching neighbour (the
        sequential reference marks a feature tracked after its first match,
        `SearchForTriangulation` only takes untracked features), then do ONE
        allocation + observation pass.

        Replaces the lax.scan-of-pairs formulation whose carry copies of the
        full MapState cost more than the matching itself. Returns (state, new_mask (P,))."""
        nb_safe = jnp.maximum(neigh, 0)
        ok_b, X_b, m2_b, _ = jax.vmap(
            lambda nb, en: candidates(state, kf1, nb, en)
        )(nb_safe, neigh >= 0)
        # first matching neighbour per feature
        first = jnp.argmax(ok_b, axis=0)  # (N,)
        any_ok = ok_b.any(axis=0)
        N = X_b.shape[1]
        rows = jnp.arange(N)
        X = X_b[first, rows]
        m2 = m2_b[first, rows]
        kf2_rows = jnp.where(any_ok, nb_safe[first], -1)
        state, slots = commit(state, kf1, kf2_rows, any_ok, X, m2)
        return state, slots

    def finalize_new_points(state: ms.MapState, pmask: jax.Array,
                            cap: int = 8192):
        """Distinctive descriptors + normals/scale bands for the union of
        freshly created points (compacted to at most `cap` slots)."""
        (idx,) = jnp.nonzero(pmask, size=cap, fill_value=state.pt_capacity)
        ok = idx < state.pt_capacity
        idx = jnp.where(ok, idx, 0).astype(jnp.int32)
        return finalize_idx(state, idx, ok)

    def finalize_idx(state: ms.MapState, idx: jax.Array, ok: jax.Array):
        """Finalization over an explicit slot vector (no mask compaction)."""
        state = ms.compute_distinctive_descriptors_idx(state, idx, ok)
        state = ms.update_normal_and_depth_idx(state, idx, ok,
                                               scale_factors, n_levels)
        return state

    @jax.jit
    def triangulate_pair(state: ms.MapState, kf1, kf2):
        """Single-pair variant (core + finalize); kept for callers that
        triangulate one neighbour at a time."""
        state, slots, pair_ok = triangulate_core(state, kf1, kf2)
        state = finalize_idx(state, jnp.clip(slots, 0), slots >= 0)
        n_new = jnp.sum((slots >= 0).astype(jnp.int32))
        return state, n_new, pair_ok

    _finalize_idx_fn = finalize_idx

    class _Triangulator:
        core = staticmethod(triangulate_core)
        batched = staticmethod(triangulate_batched)
        finalize = staticmethod(finalize_new_points)
        finalize_idx = staticmethod(_finalize_idx_fn)

        def __call__(self, state, kf1, kf2):
            return triangulate_pair(state, kf1, kf2)

    return _Triangulator()


def _median_scene_depth(state: ms.MapState, kf, cam_):
    """`KeyFrame::ComputeSceneMedianDepth` (`src/KeyFrame.cc:1375`)."""
    pts = state.kf_kp_point[kf]
    ok = pts >= 0
    pos = state.pt_pos[jnp.clip(pts, 0)]
    z = se3.transform_points(state.kf_pose[kf], pos)[:, 2]
    z = jnp.where(ok, z, jnp.inf)
    zs = jnp.sort(z)
    n = jnp.sum(ok.astype(jnp.int32))
    return zs[jnp.clip((n - 1) // 2, 0)]
