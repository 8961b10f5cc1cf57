"""Projection- and BoW-guided descriptor matching over whole frames.

Vectorized rebuild of `ORBmatcher`'s search family (SURVEY.md §2.1): instead
of per-feature grid walks (`Frame::GetFeaturesInArea`, `src/Frame.cc:445-498`)
each search builds a dense (candidates x features) mask — window radius,
octave range, rotation bins — over the full Hamming distance matrix computed
as one matmul (`ops/hamming.py`). Conflict resolution (several candidates
claiming one feature) keeps the smallest distance, matching the last-writer
overwrite semantics of the reference loops in expectation.

Implemented searches:
- `search_by_projection_points`: the local-map overload
  (`ORBmatcher::SearchByProjection`, `src/ORBmatcher.cc:45-129`) including
  `Frame::isInFrustum` gating (`src/Frame.cc:387-443`), viewing-cos radius
  2.5/4.0 (`RadiusByViewingCos`, `src/ORBmatcher.cc:131-138`), predicted
  scale from distance (`MapPoint::PredictScale`);
- `search_by_projection_last`: the frame-to-frame overload
  (`src/ORBmatcher.cc:1331-1473`) with per-octave windows and forward /
  backward scale gating;
- `search_for_initialization` (`src/ORBmatcher.cc:408-523`);
- `search_by_descriptor`: plain best/second-best matching used as the
  BoW-free core of `SearchByBoW` (node-aligned masking is added by the
  vocabulary module).

Thresholds: TH_HIGH=100, TH_LOW=50, nn-ratios per call site
(SURVEY.md appendix A).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry import projection, se3
from . import hamming

_BIG = 1 << 20


def predict_scale(dist: jax.Array, max_dist: jax.Array, scale_factor: float,
                  n_levels: int) -> jax.Array:
    """`MapPoint::PredictScale` parity: level = ceil(log(maxDist/dist)/log(s)),
    clipped to [0, L-1]."""
    ratio = max_dist / jnp.maximum(dist, 1e-9)
    lvl = jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9)) / jnp.log(scale_factor))
    return jnp.clip(lvl, 0, n_levels - 1).astype(jnp.int32)


def frustum_check(cam: projection.Camera, pose_cw: jax.Array,
                  pt_pos: jax.Array, pt_normal: jax.Array,
                  pt_min_dist: jax.Array, pt_max_dist: jax.Array,
                  bounds: jax.Array, view_cos_limit: float = 0.5):
    """`Frame::isInFrustum` (`src/Frame.cc:387-443`) for a batch of points.

    Returns (ok, uv (P,2), ur (P,), dist (P,), view_cos (P,)).
    """
    p_cam = se3.transform_points(pose_cw, pt_pos)
    z = p_cam[..., 2]
    uvr, _ = projection.project_stereo(cam, p_cam)
    uv, ur = uvr[..., :2], uvr[..., 2]
    Twc = se3.se3_inv(pose_cw)
    center = Twc[..., :3, 3]
    po = pt_pos - center
    dist = jnp.linalg.norm(po, axis=-1)
    view_cos = jnp.sum(po * pt_normal, -1) / jnp.maximum(dist, 1e-9)
    # distance-invariance margins 0.8/1.2 (`MapPoint::GetMinDistanceInvariance`
    # / `GetMaxDistanceInvariance`, `src/MapPoint.cc`, used by
    # `Frame::isInFrustum` `src/Frame.cc:416-420`). Without the slack a
    # point created at distance d is rejected the moment the camera backs
    # off past d, so the local-map search can never re-acquire dropped
    # matches and tracking decays monotonically.
    ok = (
        (z > 0)
        & (uv[..., 0] >= bounds[0]) & (uv[..., 0] < bounds[1])
        & (uv[..., 1] >= bounds[2]) & (uv[..., 1] < bounds[3])
        & (dist >= 0.8 * pt_min_dist) & (dist <= 1.2 * pt_max_dist)
        & (view_cos > view_cos_limit)
    )
    return ok, uv, ur, dist, view_cos


def _resolve_conflicts(best_feat: jax.Array, best_dist: jax.Array,
                       ok: jax.Array, n_features: int):
    """Per-feature winner among candidate rows: returns (N,) candidate index
    or -1. Ties by distance then by candidate order.

    Scatter-free: the former `.at[safe_feat].min/.max` pair serialized
    ~P scatter rows (and this helper sits on EVERY matcher's tail,
    including the per-frame local-map search and all Fuse passes). The segment-min over feature
    bins runs as a masked (P,N) min-reduction instead — two fused element-wise
    passes over ~8M lanes.
    """
    P = best_feat.shape[0]
    # score = dist * P + candidate_idx for deterministic argmin (hamming
    # distances are <= 256, so this fits int32 for P up to ~8M)
    sentinel = jnp.iinfo(jnp.int32).max
    score = jnp.where(
        ok, best_dist.astype(jnp.int32) * P + jnp.arange(P, dtype=jnp.int32),
        sentinel,
    )
    feat_ids = jnp.arange(n_features, dtype=jnp.int32)
    oh = (best_feat[:, None] == feat_ids[None, :]) & ok[:, None]  # (P,N)
    score_col = jnp.where(oh, score[:, None], sentinel)
    feat_best = jnp.min(score_col, axis=0)  # (N,)
    # winner row index = score % P of the winning score (score encodes it)
    return jnp.where(feat_best < sentinel, feat_best % P, -1)


def _pair_d2(uv: jax.Array, kp_xy: jax.Array) -> jax.Array:
    """(P,N) squared pixel distances via the expanded form — one
    matmul instead of materializing the (P,N,2) broadcast difference
    (halves the largest per-frame intermediate in every projection
    search). ~0.05 px^2 cancellation error at image-scale coords, far
    below any search-radius gate."""
    return (jnp.sum(uv * uv, -1)[:, None] + jnp.sum(kp_xy * kp_xy, -1)[None, :]
            - 2.0 * (uv @ kp_xy.T))


def search_by_projection_points(
    cam: projection.Camera,
    pose_cw: jax.Array,
    # frame features
    kp_xy: jax.Array, kp_octave: jax.Array, kp_desc_bits: jax.Array,
    kp_valid: jax.Array, kp_matched: jax.Array,
    # candidate points (already gathered to a local window)
    pt_pos: jax.Array, pt_normal: jax.Array, pt_min_dist: jax.Array,
    pt_max_dist: jax.Array, pt_desc_bits: jax.Array, pt_valid: jax.Array,
    bounds: jax.Array, scale_factors: jax.Array,
    th: float = 1.0, nn_ratio: float = 0.8,
    n_levels: int = 4, scale_factor: float = 1.5,
    dist_th: int = hamming.TH_HIGH, use_ratio: bool = True,
):
    """Local-map search. Returns (matches (N,) i32 candidate-row or -1,
    n_matches, visible_mask (P,)).

    kp_matched: features that already hold a map point are skipped
    (`src/ORBmatcher.cc:61` pMP->mbTrackInView=false path and the
    bestDist<=TH_HIGH assignment loop skipping matched features).

    dist_th/use_ratio: the relocalization re-search overload
    (`src/ORBmatcher.cc:1475-1602`) gates on an explicit ORBdist
    (100 then 64) with NO second-best ratio test — pass use_ratio=False
    and the ORBdist there.
    """
    scale_factors = jnp.asarray(scale_factors)
    N = kp_xy.shape[0]
    ok, uv, _, dist, view_cos = frustum_check(
        cam, pose_cw, pt_pos, pt_normal, pt_min_dist, pt_max_dist, bounds
    )
    ok = ok & pt_valid
    lvl = predict_scale(dist, pt_max_dist, scale_factor, n_levels)
    r = jnp.where(view_cos > 0.998, 2.5, 4.0)
    radius = th * r * scale_factors[lvl]  # ORBmatcher.cc:84-90
    # window + octave mask (P,N)
    d2 = _pair_d2(uv, kp_xy)
    in_win = d2 <= (radius[:, None] ** 2)
    oct_ok = (kp_octave[None, :] >= (lvl - 1)[:, None]) & (
        kp_octave[None, :] <= lvl[:, None]
    )
    mask = in_win & oct_ok & kp_valid[None, :] & ok[:, None] & (~kp_matched)[None, :]
    dmat = hamming.hamming_matrix_bits(pt_desc_bits, kp_desc_bits)
    idx, best, second = hamming.masked_best2(dmat, extra_mask=mask)
    # best level vs second level ratio rule (ORBmatcher.cc:109-116):
    # apply ratio only if bestLevel == bestLevel2 — approximated by always
    # applying the ratio (stricter, documented deviation).
    good = ok & (best <= dist_th)
    if use_ratio:
        good = good & (
            best.astype(jnp.float32) <= nn_ratio * second.astype(jnp.float32)
        )
    matches = _resolve_conflicts(idx, best, good, N)
    return matches, jnp.sum((matches >= 0).astype(jnp.int32)), ok


def search_by_projection_last(
    cam: projection.Camera,
    pose_cw: jax.Array,
    kp_xy: jax.Array, kp_octave: jax.Array, kp_angle: jax.Array,
    kp_desc_bits: jax.Array, kp_valid: jax.Array,
    # last-frame features with 3D points
    last_pt_pos: jax.Array, last_octave: jax.Array, last_angle: jax.Array,
    last_desc_bits: jax.Array, last_valid: jax.Array,
    bounds: jax.Array, scale_factors: jax.Array, th: float = 15.0,
    check_rotation: bool = True,
):
    """Frame-to-frame search (`src/ORBmatcher.cc:1331-1473`).

    Candidate rows are last-frame features carrying a 3D point. Window radius
    = th * scale_factor[last octave]; candidate octaves in [oct-1, oct+1]
    (the mono branch of the reference; forward/backward gating is a stereo
    refinement folded into this range). Returns (matches (N,), n).
    """
    scale_factors = jnp.asarray(scale_factors)
    N = kp_xy.shape[0]
    p_cam = se3.transform_points(pose_cw, last_pt_pos)
    uv, z = projection.project(cam, p_cam)
    ok = (
        last_valid & (z > 0)
        & (uv[..., 0] >= bounds[0]) & (uv[..., 0] < bounds[1])
        & (uv[..., 1] >= bounds[2]) & (uv[..., 1] < bounds[3])
    )
    radius = th * scale_factors[jnp.clip(last_octave, 0)]
    d2 = _pair_d2(uv, kp_xy)
    in_win = d2 <= (radius[:, None] ** 2)
    oct_ok = (kp_octave[None, :] >= (last_octave - 1)[:, None]) & (
        kp_octave[None, :] <= (last_octave + 1)[:, None]
    )
    mask = in_win & oct_ok & kp_valid[None, :] & ok[:, None]
    dmat = hamming.hamming_matrix_bits(last_desc_bits, kp_desc_bits)
    idx, best, _ = hamming.masked_best2(dmat, extra_mask=mask)
    good = ok & (best <= hamming.TH_HIGH)
    if check_rotation:
        rot_ok = hamming.rotation_consistency_mask(
            last_angle, kp_angle[jnp.clip(idx, 0)], good
        )
        good = good & rot_ok
    matches = _resolve_conflicts(idx, best, good, N)
    return matches, jnp.sum((matches >= 0).astype(jnp.int32))


def search_for_initialization(
    kp_xy_1: jax.Array, kp_angle_1: jax.Array, desc_bits_1: jax.Array,
    valid_1: jax.Array,
    kp_xy_2: jax.Array, kp_angle_2: jax.Array, desc_bits_2: jax.Array,
    valid_2: jax.Array,
    window: float = 100.0, nn_ratio: float = 0.9, check_rotation: bool = True,
):
    """`ORBmatcher::SearchForInitialization` (`src/ORBmatcher.cc:408-523`):
    match frame-1 level-0 features to frame-2 within a window, ratio test,
    rotation consistency. Caller pre-masks to octave 0 via valid_*.
    Returns (matches12 (N1,) i32, n)."""
    d2 = jnp.sum((kp_xy_1[:, None, :] - kp_xy_2[None, :, :]) ** 2, -1)
    mask = (d2 <= window * window) & valid_1[:, None] & valid_2[None, :]
    dmat = hamming.hamming_matrix_bits(desc_bits_1, desc_bits_2)
    idx, best, second = hamming.masked_best2(dmat, extra_mask=mask)
    good = valid_1 & (best <= hamming.TH_LOW) & (
        best.astype(jnp.float32) < nn_ratio * second.astype(jnp.float32)
    )
    if check_rotation:
        good = good & hamming.rotation_consistency_mask(
            kp_angle_1, kp_angle_2[jnp.clip(idx, 0)], good
        )
    # enforce one-to-one via conflict resolution on frame-2 features
    n2 = kp_xy_2.shape[0]
    winner_row = _resolve_conflicts(idx, best, good, n2)
    owner = winner_row[jnp.clip(idx, 0)]
    good = good & (owner == jnp.arange(kp_xy_1.shape[0]))
    matches = jnp.where(good, idx, -1)
    return matches, jnp.sum(good.astype(jnp.int32))


def search_for_triangulation(
    kp1_xy: jax.Array, kp1_octave: jax.Array, desc_bits_1: jax.Array,
    valid_1: jax.Array,
    kp2_xy: jax.Array, kp2_octave: jax.Array, desc_bits_2: jax.Array,
    valid_2: jax.Array,
    F12: jax.Array, epipole2: jax.Array, level_sigma2: jax.Array,
    check_epipole_dist: bool = True,
    angle_1: jax.Array | None = None, angle_2: jax.Array | None = None,
):
    """Epipolar-constrained matching for new-point triangulation
    (`ORBmatcher::SearchForTriangulation`, `src/ORBmatcher.cc:660-826`).

    F12: fundamental matrix kp1^T F12 kp2 = 0 (`ComputeF12`,
    `src/LocalMapping.cc:536-553`). Gates: Hamming < TH_LOW, epipolar line
    distance chi2 < 3.84*sigma2(octave2) (`CheckDistEpipolarLine`,
    `src/ORBmatcher.cc:140-157`), candidates not too close to the epipole
    in image 2 (`:745-750`), rotation consistency. Returns (matches (N1,), n).
    """
    level_sigma2 = jnp.asarray(level_sigma2)
    dmat = hamming.hamming_matrix_bits(desc_bits_1, desc_bits_2)
    mask = valid_1[:, None] & valid_2[None, :]
    # epipole proximity: skip kp2 within 100*scale^2 px^2 of the epipole
    if check_epipole_dist:
        de2 = jnp.sum((kp2_xy - epipole2[None, :]) ** 2, -1)
        sf2 = level_sigma2[jnp.clip(kp2_octave, 0, level_sigma2.shape[0] - 1)]
        mask = mask & (de2 >= 100.0 * sf2)[None, :]
    # epipolar line of kp1 in image 2: l = F12^T x1
    x1h = jnp.concatenate([kp1_xy, jnp.ones_like(kp1_xy[..., :1])], -1)
    lines = x1h @ F12  # (N1,3): a,b,c
    a, b, c = lines[..., 0:1], lines[..., 1:2], lines[..., 2:3]
    num = a * kp2_xy[None, :, :][..., 0] + b * kp2_xy[None, :, :][..., 1] + c
    den = a * a + b * b
    dsqr = num * num / jnp.maximum(den, 1e-12)
    sig2 = level_sigma2[jnp.clip(kp2_octave, 0, level_sigma2.shape[0] - 1)]
    mask = mask & (dsqr < 3.84 * sig2[None, :])
    idx, best, _ = hamming.masked_best2(dmat, extra_mask=mask)
    good = valid_1 & (best < hamming.TH_LOW)
    if angle_1 is not None and angle_2 is not None:
        good = good & hamming.rotation_consistency_mask(
            angle_1, angle_2[jnp.clip(idx, 0)], good
        )
    n2 = kp2_xy.shape[0]
    winner = _resolve_conflicts(idx, best, good, n2)
    owner = winner[jnp.clip(idx, 0)]
    good = good & (owner == jnp.arange(kp1_xy.shape[0]))
    return jnp.where(good, idx, -1), jnp.sum(good.astype(jnp.int32))


def _sim3_direction(cam, pt_world, pt_ok, pt_min, pt_max, pt_bits,
                    S_target_w, center_w,
                    kp_xy, kp_octave, kp_bits, kp_valid,
                    bounds, scale_factors, th, n_levels, scale_factor):
    """One direction of SearchBySim3: project source points through the
    Sim3 chain into the target camera, best-descriptor match within
    th*scale(predicted level), octave in [lvl-1, lvl], TH_HIGH gate
    (`src/ORBmatcher.cc:1151-1227`). Returns (match (P,), dist (P,))."""
    scale_factors = jnp.asarray(scale_factors)
    p_c = se3.sim3_transform_points(S_target_w, pt_world)
    z = p_c[..., 2]
    uv, _ = projection.project(cam, p_c)
    dist3d = jnp.linalg.norm(p_c, axis=-1)
    ok = (
        pt_ok & (z > 0)
        & (uv[..., 0] >= bounds[0]) & (uv[..., 0] < bounds[1])
        & (uv[..., 1] >= bounds[2]) & (uv[..., 1] < bounds[3])
        & (dist3d >= pt_min) & (dist3d <= pt_max)
    )
    lvl = predict_scale(dist3d, pt_max, scale_factor, n_levels)
    radius = th * scale_factors[lvl]
    d2 = _pair_d2(uv, kp_xy)
    in_win = d2 <= (radius[:, None] ** 2)
    oct_ok = (kp_octave[None, :] >= (lvl - 1)[:, None]) & (
        kp_octave[None, :] <= lvl[:, None]
    )
    mask = in_win & oct_ok & kp_valid[None, :] & ok[:, None]
    dmat = hamming.hamming_matrix_bits(pt_bits, kp_bits)
    idx, best, _ = hamming.masked_best2(dmat, extra_mask=mask)
    good = ok & (best <= hamming.TH_HIGH)
    del center_w
    return jnp.where(good, idx, -1), best


def search_by_sim3(
    cam: projection.Camera, T1w: jax.Array, T2w: jax.Array, S12: jax.Array,
    # KF1 per-feature tables, with the point each feature holds (world pos)
    kp1_xy, kp1_octave, kp1_bits, kp1_valid, p1_world, p1_ok, p1_min, p1_max,
    p1_bits,
    # KF2 per-feature tables
    kp2_xy, kp2_octave, kp2_bits, kp2_valid, p2_world, p2_ok, p2_min, p2_max,
    p2_bits,
    already1: jax.Array, already2: jax.Array,
    bounds: jax.Array, scale_factors: jax.Array,
    th: float = 7.5, n_levels: int = 4, scale_factor: float = 1.5,
):
    """`ORBmatcher::SearchBySim3` (`src/ORBmatcher.cc:1105-1329`): extend a
    Sim3-inlier match set by projecting KF1's points into KF2 through
    S21 ∘ T1w and KF2's points into KF1 through S12 ∘ T2w, keeping mutually
    agreeing pairs. S12 maps cam-2 coords to cam-1 coords (solver output).

    `already1/already2` mark features whose points are in the existing
    match set (skipped as sources, `:1135-1145`). Returns
    (matches12 (N1,) feature idx in KF2 or -1, n_found).
    """
    N1 = kp1_xy.shape[0]
    S21 = se3.sim3_inv(S12)
    # source points of KF1 -> target camera 2: S21 ∘ T1w (T1w is scale-1 Sim3)
    S2_of_w = S21 @ T1w
    m1, _ = _sim3_direction(
        cam, p1_world, p1_ok & ~already1, p1_min, p1_max, p1_bits,
        S2_of_w, None, kp2_xy, kp2_octave, kp2_bits, kp2_valid,
        bounds, scale_factors, th, n_levels, scale_factor)
    S1_of_w = S12 @ T2w
    m2, _ = _sim3_direction(
        cam, p2_world, p2_ok & ~already2, p2_min, p2_max, p2_bits,
        S1_of_w, None, kp1_xy, kp1_octave, kp1_bits, kp1_valid,
        bounds, scale_factors, th, n_levels, scale_factor)
    # agreement (`:1310-1326`): m1[i1] = i2 and m2[i2] = i1
    i2 = m1  # (N1,)
    back = jnp.where(i2 >= 0, m2[jnp.clip(i2, 0)], -2)
    agree = back == jnp.arange(N1, dtype=back.dtype)
    matches12 = jnp.where(agree, i2, -1)
    return matches12, jnp.sum(agree.astype(jnp.int32))


def search_by_projection_scw(
    cam: projection.Camera, Scw: jax.Array,
    pt_world, pt_ok, pt_min, pt_max, pt_normal, pt_bits,
    kp_xy, kp_octave, kp_bits, kp_valid, kp_matched,
    bounds: jax.Array, scale_factors: jax.Array,
    th: float = 10.0, n_levels: int = 4, scale_factor: float = 1.5,
):
    """`ORBmatcher::SearchByProjection(KF, Scw, ...)`
    (`src/ORBmatcher.cc:293-406`): project candidate points through a Sim3
    camera pose, gates: depth > 0, in-image, scale-invariance distance band
    (measured from the Sim3 camera center, `:348-353`), viewing angle < 60°
    (`:356-359`), octave in [lvl-1, lvl], radius th*scale(lvl), TH_LOW.
    `kp_matched` features are excluded (`:378-379`). Returns
    (matches (N,) candidate row or -1, n)."""
    scale_factors = jnp.asarray(scale_factors)
    N = kp_xy.shape[0]
    s, R, t = se3.sim3_split(Scw)
    Rcw = R
    tcw = t / s
    p_c = pt_world @ Rcw.T + tcw
    z = p_c[..., 2]
    uv, _ = projection.project(cam, p_c)
    Ow = -Rcw.T @ tcw
    po = pt_world - Ow
    dist = jnp.linalg.norm(po, axis=-1)
    view = jnp.sum(po * pt_normal, -1)
    ok = (
        pt_ok & (z > 0)
        & (uv[..., 0] >= bounds[0]) & (uv[..., 0] < bounds[1])
        & (uv[..., 1] >= bounds[2]) & (uv[..., 1] < bounds[3])
        & (dist >= pt_min) & (dist <= pt_max)
        & (view >= 0.5 * dist)
    )
    lvl = predict_scale(dist, pt_max, scale_factor, n_levels)
    radius = th * scale_factors[lvl]
    d2 = _pair_d2(uv, kp_xy)
    in_win = d2 <= (radius[:, None] ** 2)
    oct_ok = (kp_octave[None, :] >= (lvl - 1)[:, None]) & (
        kp_octave[None, :] <= lvl[:, None]
    )
    mask = in_win & oct_ok & kp_valid[None, :] & ok[:, None] & \
        (~kp_matched)[None, :]
    dmat = hamming.hamming_matrix_bits(pt_bits, kp_bits)
    idx, best, _ = hamming.masked_best2(dmat, extra_mask=mask)
    good = ok & (best <= hamming.TH_LOW)
    matches = _resolve_conflicts(idx, best, good, N)
    return matches, jnp.sum((matches >= 0).astype(jnp.int32))


def search_by_descriptor(desc_bits_1: jax.Array, valid_1: jax.Array,
                         desc_bits_2: jax.Array, valid_2: jax.Array,
                         angle_1: jax.Array | None = None,
                         angle_2: jax.Array | None = None,
                         th: int = hamming.TH_LOW, nn_ratio: float = 0.7,
                         check_rotation: bool = True,
                         node_1: jax.Array | None = None,
                         node_2: jax.Array | None = None):
    """Best/second matching with optional BoW-node alignment
    (`ORBmatcher::SearchByBoW`, `src/ORBmatcher.cc:159-291`: only features in
    the same vocabulary node are compared — pass node ids to reproduce)."""
    dmat = hamming.hamming_matrix_bits(desc_bits_1, desc_bits_2)
    mask = valid_1[:, None] & valid_2[None, :]
    if node_1 is not None and node_2 is not None:
        mask = mask & (node_1[:, None] == node_2[None, :])
    idx, best, second = hamming.masked_best2(dmat, extra_mask=mask)
    good = valid_1 & (best <= th) & (
        best.astype(jnp.float32) < nn_ratio * second.astype(jnp.float32)
    )
    if check_rotation and angle_1 is not None:
        good = good & hamming.rotation_consistency_mask(
            angle_1, angle_2[jnp.clip(idx, 0)], good
        )
    n2 = desc_bits_2.shape[0]
    winner_row = _resolve_conflicts(idx, best, good, n2)
    owner = winner_row[jnp.clip(idx, 0)]
    good = good & (owner == jnp.arange(desc_bits_1.shape[0]))
    return jnp.where(good, idx, -1), jnp.sum(good.astype(jnp.int32))
