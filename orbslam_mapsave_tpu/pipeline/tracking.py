"""Per-frame tracking: the reference's `Tracking` thread as pure device steps
plus a thin host state machine.

`Tracking` parity (`src/Tracking.cc`, SURVEY.md §3.2): states
{NO_IMAGES_YET, NOT_INITIALIZED, OK, LOST} (`include/Tracking.h:85-91`),
per-frame flow Track() (`src/Tracking.cc:541-741`):

  frame build -> (init | motion-model track | refKF track | reloc)
              -> local-map track -> velocity update -> keyframe decision

Each stage is a jitted function over fixed-capacity arrays; the host only
branches on scalar outcomes (match counts), mirroring the reference's
control flow with the numeric gates of SURVEY.md appendix A.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import projection, se3
from ..ops import hamming, matching
from ..ops import initializer as initializer_mod
from ..optim import pose_opt
from ..slammap import mapstate as ms
from . import frame as frame_mod

NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2
LOST = 3

LOCAL_KFS = 80  # Tracking.cc:1545
LOCAL_PTS = 4096  # static cap for the gathered local point set


class TrackOutcome(NamedTuple):
    pose_cw: jax.Array
    matched_pt: jax.Array  # (N,) map-point slot per feature or -1
    n_matches: jax.Array
    n_inliers: jax.Array


def _desc_bits_of_points(state: ms.MapState, idx: jax.Array) -> jax.Array:
    return hamming.unpack_bits(state.pt_desc[jnp.clip(idx, 0)])


def make_tracking_kernels(cam: projection.Camera, builder: frame_mod.FrameBuilder,
                          n_levels: int, scale_factor: float):
    """Build the jitted step functions for a fixed geometry/config."""
    scale_factors = builder.scale_factors
    bounds = builder.bounds

    @jax.jit
    def init_rgbd(state: ms.MapState, frame: frame_mod.FrameData, frame_id):
        """`Tracking::StereoInitialization` (`src/Tracking.cc:750-802`):
        first KF at the origin; every feature with depth becomes a point."""
        pose = jnp.eye(4, dtype=jnp.float32)
        state, kf = ms.add_keyframe(
            state, pose, frame.timestamp, frame_id,
            frame.kp_xy, frame.kp_ur, frame.kp_depth, frame.kp_octave,
            frame.kp_angle, frame.valid, frame.desc,
        )
        has_depth = frame.valid & (frame.kp_depth > 0)
        pts = projection.backproject(cam, frame.kp_xy, frame.kp_depth)
        state, slots = ms.add_points(
            state, pts, frame.desc, kf, kf, has_depth
        )
        feat = jnp.arange(frame.kp_xy.shape[0], dtype=jnp.int32)
        state = ms.add_observations(state, kf, slots, feat, has_depth)
        state = ms.compute_distinctive_descriptors_idx(
            state, jnp.clip(slots, 0), slots >= 0)
        state = ms.update_normal_and_depth_idx(
            state, jnp.clip(slots, 0), slots >= 0, scale_factors, n_levels)
        state = ms.update_connections(state, kf)
        matched = jnp.where(has_depth, slots, -1)
        return state, kf, matched, jnp.sum(has_depth.astype(jnp.int32))

    @jax.jit
    def track_motion(state: ms.MapState, frame: frame_mod.FrameData,
                     pose_pred: jax.Array,
                     last_matched: jax.Array, last_frame: frame_mod.FrameData,
                     th: jax.Array, last_pose: jax.Array,
                     use_temporal: jax.Array):
        """`Tracking::TrackWithMotionModel` (`src/Tracking.cc:1114-1175`) +
        the temporal "VO point" seeding of `UpdateLastFrame`
        (`src/Tracking.cc:1048-1112`): in localization-only mode
        (use_temporal), last-frame features with depth but WITHOUT a map
        point become temporary 3D candidates back-projected through the
        last pose, so odometry keeps working where the loaded map is
        sparse. Returns (matched_pt (N,) map slot or -1, pt_w (N,3) matched
        3D position — map or temporal, have (N,), n_matches)."""
        ok_map = last_matched >= 0
        pt_pos = state.pt_pos[jnp.clip(last_matched, 0)]
        ok_map = ok_map & state.pt_valid[jnp.clip(last_matched, 0)]
        has_temp = use_temporal & last_frame.valid & \
            (last_frame.kp_depth > 0) & ~ok_map
        p_cam = projection.backproject(cam, last_frame.kp_xy,
                                       last_frame.kp_depth)
        p_w_temp = se3.transform_points(se3.se3_inv(last_pose), p_cam)
        pt_pos = jnp.where(ok_map[:, None], pt_pos, p_w_temp)
        ok_last = ok_map | has_temp
        matches, n = matching.search_by_projection_last(
            cam, pose_pred,
            frame.kp_xy, frame.kp_octave, frame.kp_angle, frame.desc_bits,
            frame.valid,
            pt_pos, last_frame.kp_octave, last_frame.kp_angle,
            last_frame.desc_bits, ok_last,
            bounds, scale_factors, th=th,
        )
        # matches: per current feature -> last-frame row; temporal rows map
        # to slot -1 (they never enter the map) but keep their 3D position
        have = matches >= 0
        row = jnp.clip(matches, 0)
        matched_pt = jnp.where(have & ok_map[row], last_matched[row], -1)
        pt_w = pt_pos[row]
        return matched_pt, pt_w, have, n

    @jax.jit
    def track_ref_kf(state: ms.MapState, frame: frame_mod.FrameData, ref_kf):
        """`Tracking::TrackReferenceKeyFrame` (`src/Tracking.cc:1004-1046`).

        DESIGN: the reference gates candidate pairs by BoW node alignment
        (SearchByBoW, `src/ORBmatcher.cc:177-183`) because a CPU cannot
        afford the full N^2 Hamming matrix; on a matmul unit the full
        matrix IS the cheap path (one bit-plane matmul), so this uses exhaustive
        descriptor matching with the same ratio (0.7) + rotation gates —
        a strict SUPERSET of the reference's candidate set (node-gating
        only ever removes true matches). `search_by_descriptor` still
        accepts node ids for callers that want exact BoW-gated parity."""
        kf_bits = hamming.unpack_bits(state.kf_desc[ref_kf])
        kf_pts = state.kf_kp_point[ref_kf]
        kf_ok = state.kf_kp_valid[ref_kf] & (kf_pts >= 0)
        kf_ok = kf_ok & state.pt_valid[jnp.clip(kf_pts, 0)]
        matches, n = matching.search_by_descriptor(
            frame.desc_bits, frame.valid, kf_bits, kf_ok,
            frame.kp_angle, state.kf_kp_angle[ref_kf],
            th=hamming.TH_LOW, nn_ratio=0.7,
        )
        matched_pt = jnp.where(matches >= 0, kf_pts[jnp.clip(matches, 0)], -1)
        return matched_pt, n

    @jax.jit
    def optimize_pose(state: ms.MapState, frame: frame_mod.FrameData,
                      pose0: jax.Array, matched_pt: jax.Array):
        """PoseOptimization wrapper + outlier stripping
        (`src/Tracking.cc:1154-1174`)."""
        ok = (matched_pt >= 0) & state.pt_valid[jnp.clip(matched_pt, 0)]
        obs = pose_opt.PoseObs(
            pt_w=state.pt_pos[jnp.clip(matched_pt, 0)],
            uv=frame.kp_xy,
            ur=frame.kp_ur,
            inv_sigma2=jnp.asarray(builder.inv_level_sigma2)[
                jnp.clip(frame.kp_octave, 0)],
            valid=ok,
        )
        pose, inlier, n_inl = pose_opt.pose_optimization(cam, pose0, obs)
        matched_pt = jnp.where(inlier, matched_pt, -1)
        return pose, matched_pt, n_inl

    @jax.jit
    def optimize_pose_xyz(state: ms.MapState, frame: frame_mod.FrameData,
                          pose0: jax.Array, pt_w: jax.Array, have: jax.Array,
                          matched_pt: jax.Array):
        """PoseOptimization over EXPLICIT 3D positions — the motion-model
        variant where some matches are temporal VO points with no map slot
        (`src/Tracking.cc:1048-1175`). Returns (pose, matched_pt stripped of
        outliers, n_inliers, n_map_inliers) — the map-only count drives the
        mbVO ladder (`:612-615`)."""
        obs = pose_opt.PoseObs(
            pt_w=pt_w,
            uv=frame.kp_xy,
            ur=frame.kp_ur,
            inv_sigma2=jnp.asarray(builder.inv_level_sigma2)[
                jnp.clip(frame.kp_octave, 0)],
            valid=have,
        )
        pose, inlier, n_inl = pose_opt.pose_optimization(cam, pose0, obs)
        matched_pt = jnp.where(inlier, matched_pt, -1)
        n_map = jnp.sum((inlier & (matched_pt >= 0)).astype(jnp.int32))
        return pose, matched_pt, n_inl, n_map

    @jax.jit
    def gather_local_map(state: ms.MapState, matched_pt: jax.Array,
                         pose: jax.Array):
        """`Tracking::UpdateLocalKeyFrames/Points` (`src/Tracking.cc:1455-1599`):
        vote for KFs observing current points; local map = points of the
        top-80 voted KFs. Returns (local_pt_idx (LOCAL_PTS,), ref_kf).

        Scatter-free membership: the selected-KF set is packed into
        ceil(K/32) bitmask words, and each point tests its observer lanes
        with vectorized shifts — replacing a row-gather + 184k-element
        scatter flag build. Points outside the current frustum
        (with a 25% window margin) are dropped BEFORE compaction, so the
        LOCAL_PTS lanes hold only candidates `SearchLocalPoints` could
        actually match (`src/Tracking.cc:1403-1453` culls the same way via
        isInFrustum)."""
        K = state.kf_capacity
        ok = (matched_pt >= 0)
        safe = jnp.clip(matched_pt, 0)
        obs_kf = state.pt_obs_kf[safe]  # (N,O)
        obs_ok = ok[:, None] & (obs_kf >= 0)
        votes = jnp.zeros(K, jnp.int32).at[
            jnp.where(obs_ok, obs_kf, K - 1).reshape(-1)
        ].add(obs_ok.reshape(-1).astype(jnp.int32), mode="drop")
        votes = jnp.where(state.kf_valid, votes, 0)
        ref_kf = jnp.argmax(votes).astype(jnp.int32)
        top_votes, top_kfs = jax.lax.top_k(votes, min(LOCAL_KFS, K))
        kf_sel = top_votes > 0
        # add covisible neighbors of voted KFs (Tracking.cc:1550-1563)
        neigh = ms.covisible_keyframes(state, ref_kf, 10)
        sel = jnp.concatenate([jnp.where(kf_sel, top_kfs.astype(jnp.int32), -1),
                               neigh])  # (S,)
        n_words = (K + 31) // 32
        words = jnp.zeros(n_words, jnp.int32).at[
            jnp.clip(sel, 0) >> 5
        ].max(jnp.where(sel >= 0, 1 << (jnp.clip(sel, 0) & 31), 0),
              mode="drop")
        # per-point observer test against the bitmask (pure element-wise shifts)
        po = state.pt_obs_kf  # (P,O)
        po_safe = jnp.clip(po, 0)
        bit = jnp.zeros(po.shape, jnp.int32)
        for w in range(n_words):
            bit = bit | jnp.where(
                (po_safe >> 5) == w,
                (words[w] >> (po_safe & 31)) & 1, 0)
        in_local = ((bit > 0) & (po >= 0)).any(-1) & state.pt_valid
        # frustum prefilter at 1.25x image bounds (projection margin for
        # the search window radius)
        p_cam = se3.transform_points(pose, state.pt_pos)
        z = p_cam[:, 2]
        zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = cam.fx * p_cam[:, 0] / zs + cam.cx
        v = cam.fy * p_cam[:, 1] / zs + cam.cy
        mx = 0.25 * (bounds[1] - bounds[0])
        my = 0.25 * (bounds[3] - bounds[2])
        in_view = (z > 0) & (u >= bounds[0] - mx) & (u < bounds[1] + mx) \
            & (v >= bounds[2] - my) & (v < bounds[3] + my)
        pt_flag = (in_local & in_view).astype(jnp.int8)
        local_idx = ms.compact_indices(pt_flag,
                                       min(LOCAL_PTS, state.pt_capacity))
        return local_idx, ref_kf

    @jax.jit
    def track_local_map(state: ms.MapState, frame: frame_mod.FrameData,
                        pose: jax.Array, matched_pt: jax.Array,
                        local_idx: jax.Array, th: jax.Array):
        """`Tracking::SearchLocalPoints` + pose opt
        (`src/Tracking.cc:1177-1221,1403-1453`)."""
        lp = jnp.clip(local_idx, 0)
        lp_valid = (local_idx >= 0) & state.pt_valid[lp]
        # skip points already matched in this frame (Tracking.cc:1408-1419)
        already = jnp.zeros(state.pt_capacity, bool).at[
            jnp.clip(matched_pt, 0)
        ].set(matched_pt >= 0)
        lp_valid = lp_valid & ~already[lp]
        new_matches, n_new, visible = matching.search_by_projection_points(
            cam, pose,
            frame.kp_xy, frame.kp_octave, frame.desc_bits, frame.valid,
            matched_pt >= 0,
            state.pt_pos[lp], state.pt_normal[lp], state.pt_min_dist[lp],
            state.pt_max_dist[lp], _desc_bits_of_points(state, local_idx),
            lp_valid, bounds, scale_factors, th=th,
            n_levels=n_levels, scale_factor=scale_factor,
        )
        merged = jnp.where(
            (new_matches >= 0) & (matched_pt < 0),
            local_idx[jnp.clip(new_matches, 0)], matched_pt
        )
        pose2, merged, n_inl = optimize_pose(state, frame, pose, merged)
        # visibility bookkeeping (MapPoint::IncreaseVisible/Found analogue)
        vis_idx = jnp.where(lp_valid & visible, lp, state.pt_capacity - 1)
        visible_upd = state.pt_visible.at[vis_idx].add(1, mode="drop")
        fnd_idx = jnp.clip(merged, 0)
        found_upd = state.pt_found.at[fnd_idx].add(
            jnp.where(merged >= 0, 1, 0), mode="drop"
        )
        state = state._replace(pt_visible=visible_upd, pt_found=found_upd)
        return state, pose2, merged, n_inl

    @jax.jit
    def create_keyframe_rgbd(state: ms.MapState, frame: frame_mod.FrameData,
                             pose: jax.Array, matched_pt: jax.Array, frame_id,
                             close_depth_th: jax.Array):
        """`Tracking::CreateNewKeyFrame` (`src/Tracking.cc:1323-1401`): insert
        KF; walk features with depth by increasing depth, seed a point for
        every untracked one; past thDepth, stop once 100 points (tracked or
        created) are accounted for — the reference's `vDepthIdx` sort with
        the `z > mThDepth && nPoints > 100` break (`src/Tracking.cc:
        1358-1394`): every CLOSE feature seeds, far ones only fill up to
        the 100 budget."""
        state, kf = ms.add_keyframe(
            state, pose, frame.timestamp, frame_id,
            frame.kp_xy, frame.kp_ur, frame.kp_depth, frame.kp_octave,
            frame.kp_angle, frame.valid, frame.desc,
        )
        # existing matches become observations of the new KF
        feat = jnp.arange(frame.kp_xy.shape[0], dtype=jnp.int32)
        has_match = (matched_pt >= 0) & state.pt_valid[jnp.clip(matched_pt, 0)]
        state = ms.add_observations(state, kf, matched_pt, feat, has_match)
        # new points nearest-first; far features only within the 100 budget
        has_depth = frame.valid & (frame.kp_depth > 0)
        depth_key = jnp.where(has_depth, frame.kp_depth, jnp.inf)
        counted = has_depth  # every walked feature bumps nPoints
        order = jnp.argsort(depth_key)
        running = jnp.cumsum(counted[order].astype(jnp.int32))
        before_break = jnp.zeros_like(counted).at[order].set(
            (running <= 100) | (depth_key[order] < close_depth_th)
        )
        need_new = has_depth & ~has_match & before_break
        p_cam = projection.backproject(cam, frame.kp_xy, frame.kp_depth)
        Twc = se3.se3_inv(pose)
        p_world = se3.transform_points(Twc, p_cam)
        state, slots = ms.add_points(state, p_world, frame.desc, kf, kf, need_new)
        state = ms.add_observations(state, kf, slots, feat, need_new)
        state = ms.compute_distinctive_descriptors_idx(
            state, jnp.clip(slots, 0), slots >= 0)
        state = ms.update_normal_and_depth_idx(
            state, jnp.clip(slots, 0), slots >= 0, scale_factors, n_levels)
        state = ms.update_connections(state, kf)
        matched = jnp.where(need_new, slots, matched_pt)
        return state, kf, matched

    @jax.jit
    def match_for_initialization(f1: frame_mod.FrameData,
                                 f2: frame_mod.FrameData):
        """`SearchForInitialization` window=100 nn=0.9 on level-0 features
        (`src/Tracking.cc:843`)."""
        v1 = f1.valid & (f1.kp_octave == 0)
        v2 = f2.valid & (f2.kp_octave == 0)
        return matching.search_for_initialization(
            f1.kp_xy, f1.kp_angle, f1.desc_bits, v1,
            f2.kp_xy, f2.kp_angle, f2.desc_bits, v2,
            window=100.0, nn_ratio=0.9,
        )

    @jax.jit
    def create_initial_map_mono(state: ms.MapState, f1: frame_mod.FrameData,
                                f2: frame_mod.FrameData, frame_id1, frame_id2,
                                matches12: jax.Array, R21, t21,
                                pts3d: jax.Array, good: jax.Array):
        """`Tracking::CreateInitialMapMonocular` (`src/Tracking.cc:882-984`):
        two KFs, triangulated points, connections, then median-depth scale
        normalization (GBA runs host-side right after)."""
        T1 = jnp.eye(4, dtype=jnp.float32)
        T2 = se3.rt_to_mat(R21, t21).astype(jnp.float32)
        state, kf1 = ms.add_keyframe(
            state, T1, f1.timestamp, frame_id1, f1.kp_xy, f1.kp_ur,
            f1.kp_depth, f1.kp_octave, f1.kp_angle, f1.valid, f1.desc,
        )
        state, kf2 = ms.add_keyframe(
            state, T2, f2.timestamp, frame_id2, f2.kp_xy, f2.kp_ur,
            f2.kp_depth, f2.kp_octave, f2.kp_angle, f2.valid, f2.desc,
        )
        ok = good & (matches12 >= 0)
        m2 = jnp.clip(matches12, 0)
        state, slots = ms.add_points(state, pts3d, f1.desc, kf1, kf1, ok)
        feat1 = jnp.arange(f1.kp_xy.shape[0], dtype=jnp.int32)
        state = ms.add_observations(state, kf1, slots, feat1, ok)
        state = ms.add_observations(state, kf2, slots, m2, ok)
        pmask = jnp.zeros(state.pt_capacity, bool).at[jnp.clip(slots, 0)].set(
            slots >= 0
        )
        state = ms.compute_distinctive_descriptors_idx(
            state, jnp.clip(slots, 0), slots >= 0)
        state = ms.update_normal_and_depth_idx(
            state, jnp.clip(slots, 0), slots >= 0, scale_factors, n_levels)
        state = ms.update_connections(state, kf1)
        state = ms.update_connections(state, kf2)
        # median scene depth of KF1 for scale normalization (Tracking.cc:934-960)
        z = se3.transform_points(T1, state.pt_pos)[:, 2]
        zv = jnp.where(pmask, z, jnp.inf)
        n_pts = jnp.sum(pmask.astype(jnp.int32))
        med = jnp.sort(zv)[jnp.clip((n_pts - 1) // 2, 0)]
        inv_med = 1.0 / jnp.maximum(med, 1e-9)
        # scale translation of KF2 + all points
        T2s = T2.at[:3, 3].multiply(inv_med)
        state = state._replace(
            kf_pose=state.kf_pose.at[kf2].set(T2s),
            pt_pos=jnp.where(pmask[:, None], state.pt_pos * inv_med,
                             state.pt_pos),
        )
        n2 = f2.kp_xy.shape[0]
        safe_m2 = jnp.where(ok, m2, n2 - 1)
        matched2 = jnp.full((n2,), -1, jnp.int32).at[safe_m2].max(
            jnp.where(ok, slots, -1)
        )
        return state, kf1, kf2, matched2, n_pts, med

    @jax.jit
    def create_keyframe_mono(state: ms.MapState, frame: frame_mod.FrameData,
                             pose: jax.Array, matched_pt: jax.Array, frame_id):
        """Mono `CreateNewKeyFrame` — no depth-seeded points
        (`src/Tracking.cc:1331-1334` early return for mono)."""
        state, kf = ms.add_keyframe(
            state, pose, frame.timestamp, frame_id,
            frame.kp_xy, frame.kp_ur, frame.kp_depth, frame.kp_octave,
            frame.kp_angle, frame.valid, frame.desc,
        )
        feat = jnp.arange(frame.kp_xy.shape[0], dtype=jnp.int32)
        has = (matched_pt >= 0) & state.pt_valid[jnp.clip(matched_pt, 0)]
        state = ms.add_observations(state, kf, matched_pt, feat, has)
        state = ms.update_connections(state, kf)
        return state, kf

    return dict(
        init_rgbd=init_rgbd,
        track_motion=track_motion,
        track_ref_kf=track_ref_kf,
        optimize_pose=optimize_pose,
        optimize_pose_xyz=optimize_pose_xyz,
        gather_local_map=gather_local_map,
        track_local_map=track_local_map,
        create_keyframe_rgbd=create_keyframe_rgbd,
        match_for_initialization=match_for_initialization,
        create_initial_map_mono=create_initial_map_mono,
        create_keyframe_mono=create_keyframe_mono,
    )


@dataclasses.dataclass
class TrackerConfig:
    min_frames: int = 0  # Tracking.cc:163-174
    max_frames: int = 30  # = fps
    th_depth: float = 3.0  # meters (bf/fx * ThDepth)
    min_init_features: int = 500  # Tracking.cc:752
    motion_th: float = 15.0  # RGBD/mono window (Tracking.cc:1127)
    local_th: float = 3.0  # RGBD local search (Tracking.cc:1447); mono 1
    is_mono: bool = False


class Tracker:
    """Host driver over the fused device step (replaces the Tracking
    thread's member state, `include/Tracking.h:85-228`).

    Steady state enqueues ONE device program per frame
    (`fused_step.make_fused_step`) and fetches `StepOutcome` records in
    batches of `fetch_every`, so the device queue never waits on the
    per-frame `int(...)` branching of a literal translation (the cadence
    is still to be measured on the GPU, ROADMAP Queue 1). Host-mediated
    paths: monocular bootstrap and relocalization (both rare)."""

    def __init__(self, cam: projection.Camera, builder: frame_mod.FrameBuilder,
                 state: ms.MapState, cfg: TrackerConfig,
                 n_levels: int = 4, scale_factor: float = 1.5,
                 mapper=None, fetch_every: int = 16):
        from . import fused_step

        self.cam = cam
        self.builder = builder
        self.map = state
        self.cfg = cfg
        self.k = make_tracking_kernels(cam, builder, n_levels, scale_factor)
        self.step = fused_step.make_fused_step(
            cam, builder, n_levels, scale_factor, cfg, mapper)
        # frame build + fused step COMPOSED into one program: one launch
        # per frame instead of two
        self._composed_rgbd = jax.jit(
            lambda state, ctrl, image, ts, depth: self.step(
                state, ctrl, builder._build_rgbd(image, ts, depth, None)))
        self._composed_mono = jax.jit(
            lambda state, ctrl, image, ts: self.step(
                state, ctrl, builder._build_mono(image, ts, None)))
        self.fetch_every = fetch_every
        self.ctrl: fused_step.ControlState | None = None
        self.state = NO_IMAGES_YET  # host view (may lag the device by a batch)
        self.last_frame: frame_mod.FrameData | None = None
        self.ref_kf = 0
        self.frame_id = 0
        self.new_kf_slots: list[int] = []  # loop-closing queue (host view)
        self.host_kf_slots: list[int] = []  # KFs created on the host (mono init)
        self.disallow_kf = False  # localization-only mode (no KF creation)
        self.relocalizer = None  # set by SLAMSystem when a vocabulary exists
        # f64 timestamp epoch: device arrays are f32, which cannot hold a
        # real TUM epoch stamp (1.3e9 loses ~4s at f32 — `src/System.cc:
        # 753-787` keeps timestamps double). Device-side stamps are f32
        # OFFSETS from this host-side f64 epoch (first frame's stamp);
        # exports add it back (VERDICT r3 weak #4).
        self.ts_epoch: float | None = None
        self._init_frame = None  # mono initializer reference frame
        self._pending: list[tuple[float, object]] = []  # (t, StepOutcome)
        self._trajectory: list[tuple[float, np.ndarray, bool]] = []
        self.n_inliers = 0
        self.mb_vo = False  # map-less odometry active (Tracking.cc:595-640)
        self.needs_reset = False  # lost-after-init ladder (Tracking.cc:712-718)
        self.n_pt_watermark = 0
        self.n_kf_watermark = 0
        # O_BA truncation telemetry (VERDICT r4 weak #3): lanes the local
        # BA dropped even after O_BA_ESC escalation, and escalation count
        self.ba_lanes_dropped = 0
        self.ba_escalations = 0

    # ---- deferred outcome handling ----------------------------------
    @property
    def trajectory(self) -> list[tuple[float, np.ndarray, bool]]:
        self.flush()
        return self._trajectory

    def flush(self):
        """Fetch all pending step outcomes in one batched transfer.

        Full drain on purpose: a fetch waits for the whole enqueued
        device queue, so the fewest, largest fetch points keep the queue
        full."""
        if not self._pending:
            return
        take = self._pending
        self._pending = []
        ts = [t for t, _ in take]
        outs = jax.device_get([o for _, o in take])
        from . import fused_step

        for t, out in zip(ts, outs):
            lost = int(out.mode) != fused_step.MODE_OK
            self._trajectory.append(
                (t, np.asarray(out.pose), lost)
            )
            if bool(out.kf_created):
                self.new_kf_slots.append(int(out.kf_slot))
            self.n_inliers = int(out.n_inliers)
            self.ba_lanes_dropped += int(out.ba_lanes_dropped)
            self.ba_escalations += int(out.ba_escalated)
        last = outs[-1]
        self.n_pt_watermark = int(last.n_pt)  # allocator high-water marks
        # ALLOCATOR watermark, not the valid count: under heavy keyframe
        # culling (mono) the allocator can exhaust kf_capacity while the
        # valid count sits far below the compaction trigger — keyframe
        # creation then stops silently at the cap_ok gate (r4 mono bug)
        self.n_kf_watermark = int(last.n_kf_alloc)
        mode = int(last.mode)
        self.state = {1: NOT_INITIALIZED, 2: OK, 3: LOST}.get(mode, mode)
        self.mb_vo = bool(last.mb_vo)
        # lost right after initialization (<= 5 KFs) -> full system reset
        # (`src/Tracking.cc:712-718`); the SLAMSystem drains the flag
        if (self.state == LOST and not self.disallow_kf
                and int(last.n_kf) <= 5):
            self.needs_reset = True

    def _ensure_ctrl(self, fr: frame_mod.FrameData):
        if self.ctrl is None:
            from . import fused_step

            self.ctrl = fused_step.initial_control_state(
                fr.kp_xy.shape[0], fr)
            if self.state == LOST:  # reuse mode: relocalize vs loaded map
                self.ctrl = self.ctrl._replace(
                    mode=jnp.asarray(fused_step.MODE_LOST, jnp.int32))
            if getattr(self, "disallow_kf", False):
                self.ctrl = self.ctrl._replace(allow_kf=jnp.asarray(False))

    def _enqueue(self, fr: frame_mod.FrameData, t: float):
        self.map, self.ctrl, out = self.step(self.map, self.ctrl, fr)
        return self._post_enqueue(out, t, fr)

    def _post_enqueue(self, out, t: float, fr=None):
        if fr is None:
            fr = self.ctrl.last_frame  # the composed step stores it
        self._pending.append((t, out))
        self.last_frame = fr
        self.frame_id += 1
        # while LOST (or in map-less VO), drop to per-frame fetches so
        # relocalization retries EVERY frame like the reference
        # (`src/Tracking.cc:595-640,1601`); the steady OK state keeps the
        # batched cadence that hides the host<->device latency
        every = 1 if (self.state == LOST or self.mb_vo) else self.fetch_every
        if len(self._pending) >= every:
            self.flush()
            if self.state == LOST or self.mb_vo:
                self._host_relocalize(fr, t)
        return out.pose

    def _host_relocalize(self, fr: frame_mod.FrameData, t: float):
        """Relocalization on the most recent frame
        (`Tracking::Relocalization`, `src/Tracking.cc:1601-1775`). The
        reference retries every frame while lost; the batched host view
        retries every `fetch_every` frames."""
        from . import fused_step

        pose = None
        matched = None
        if self.relocalizer is not None:
            out = self.relocalizer.relocalize(
                self.map, fr, self.k["optimize_pose"], self.frame_id)
            if out is not None:
                pose, matched, _ = out
        if pose is None and self.state == LOST:
            # fallback: reference-KF matching retry (not in mbVO mode — the
            # reference only runs Relocalization there, Tracking.cc:607-611)
            matched, n = self.k["track_ref_kf"](
                self.map, fr, jnp.asarray(self.ref_kf, jnp.int32))
            if int(n) >= 15:
                p2, matched, n_inl = self.k["optimize_pose"](
                    self.map, fr, self.ctrl.pose, matched)
                if int(n_inl) >= 10:
                    pose = p2
        if pose is not None:
            self.ctrl = self.ctrl._replace(
                mode=jnp.asarray(fused_step.MODE_OK, jnp.int32),
                pose=jnp.asarray(pose, jnp.float32),
                has_velocity=jnp.asarray(False),
                last_matched=jnp.asarray(matched, jnp.int32),
                mb_vo=jnp.asarray(False),
            )
            self.state = OK
            self.mb_vo = False

    def _dev_ts(self, timestamp: float) -> float:
        """f32-safe device timestamp: offset from the run's f64 epoch."""
        if self.ts_epoch is None:
            self.ts_epoch = float(timestamp)
        return float(timestamp) - self.ts_epoch

    # -- per-frame entry (GrabImageRGBD analogue, Tracking.cc:300-360) -----
    def track_rgbd(self, image, depth, timestamp: float):
        t_dev = self._dev_ts(timestamp)
        image = jnp.asarray(image)
        depth = jnp.asarray(depth)
        if self.ctrl is None:
            fr0 = self.builder.build(image, t_dev, depth)
            self._ensure_ctrl(fr0)
        self.map, self.ctrl, out = self._composed_rgbd(
            self.map, self.ctrl, image, t_dev, depth)
        return self._post_enqueue(out, float(timestamp))

    # -- stereo entry (GrabImageStereo, Tracking.cc:246-298) ---------------
    def track_stereo(self, image_left, image_right, timestamp: float):
        t_dev = self._dev_ts(timestamp)
        fr = self.builder.build_stereo(image_left, image_right, t_dev)
        self._ensure_ctrl(fr)
        return self._enqueue(fr, float(timestamp))

    # -- monocular entry (GrabImageMonocular, Tracking.cc:405-441) ---------
    def track_monocular(self, image, timestamp: float):
        t_dev = self._dev_ts(timestamp)
        image = jnp.asarray(image)
        if self.state in (NO_IMAGES_YET, NOT_INITIALIZED) or self.ctrl is None:
            fr = self.builder.build(image, t_dev)
            self._ensure_ctrl(fr)
            if self.state in (NO_IMAGES_YET, NOT_INITIALIZED):
                pose = self._mono_initialize(fr, float(timestamp))
                self.frame_id += 1
                return pose
        self.map, self.ctrl, out = self._composed_mono(
            self.map, self.ctrl, image, t_dev)
        return self._post_enqueue(out, float(timestamp))

    def _mono_initialize(self, fr: frame_mod.FrameData,
                         t: float) -> np.ndarray | None:
        """`Tracking::MonocularInitialization` (`src/Tracking.cc:804-880`) +
        `CreateInitialMapMonocular` (`:882-984`). Host-mediated: it happens
        once, so its scalar branching cost is irrelevant. `t` is the
        ABSOLUTE f64 stamp (fr.timestamp is the f32 epoch offset)."""
        import jax as _jax

        n_feat = int(jnp.sum(fr.valid))
        self.last_frame = fr
        if getattr(self, "_init_frame", None) is None:
            if n_feat > 100:  # Tracking.cc:809
                self._init_frame = fr
                self._init_frame_id = self.frame_id
            self.state = NOT_INITIALIZED
            self._record(None, True, t)
            return None
        if n_feat <= 100:  # discard initializer (Tracking.cc:830-836)
            self._init_frame = None
            self._record(None, True, t)
            return None
        matches12, n = self.k["match_for_initialization"](self._init_frame, fr)
        if int(n) < 100:  # Tracking.cc:847-853
            self._init_frame = None
            self._record(None, True, t)
            return None
        K = np.array([
            [float(self.cam.fx), 0, float(self.cam.cx)],
            [0, float(self.cam.fy), float(self.cam.cy)],
            [0, 0, 1.0],
        ], np.float32)
        # align matched pairs: kp1[i] <-> kp2[matches12[i]]
        m = np.asarray(matches12)
        sel = m >= 0
        kp1 = self._init_frame.kp_xy
        kp2_full = np.asarray(fr.kp_xy)
        kp2_aligned = np.zeros_like(np.asarray(kp1))
        kp2_aligned[sel] = kp2_full[m[sel]]
        out = initializer_mod.initialize_two_view(
            _jax.random.PRNGKey(self.frame_id), jnp.asarray(kp1),
            jnp.asarray(kp2_aligned), jnp.asarray(sel), 200, jnp.asarray(K),
        )
        if not bool(out["success"]):
            self._record(None, True, t)
            return None
        state, kf1, kf2, matched2, n_pts, med = self.k["create_initial_map_mono"](
            self.map, self._init_frame, fr, self._init_frame_id,
            self.frame_id, matches12, out["R21"], out["t21"],
            out["points3d"], out["good"],
        )
        if float(med) < 0 or int(n_pts) < 100:  # Tracking.cc:937-944
            self._record(None, True, t)
            return None
        # GlobalBundleAdjustemnt(20) on the bootstrap pair
        # (`src/Tracking.cc:931` — robust, gauge = first KF)
        from ..optim import global_ba

        poses_gba, pts_gba, _ = global_ba.full_bundle_adjustment(
            self.cam, state, self.builder.inv_level_sigma2,
            n_iters=20, robust=True, solver="dense")
        state = state._replace(kf_pose=poses_gba, pt_pos=pts_gba)
        self.map = state
        self.state = OK
        self.ref_kf = int(kf2)
        pose = np.asarray(self.map.kf_pose[kf2])
        self.host_kf_slots += [int(kf1), int(kf2)]
        self._init_frame = None
        from . import fused_step

        self.ctrl = self.ctrl._replace(
            mode=jnp.asarray(fused_step.MODE_OK, jnp.int32),
            pose=jnp.asarray(pose, jnp.float32),
            has_velocity=jnp.asarray(False),
            ref_kf=jnp.asarray(int(kf2), jnp.int32),
            frame_id=jnp.asarray(self.frame_id + 1, jnp.int32),
            last_kf_frame_id=jnp.asarray(self.frame_id, jnp.int32),
            last_matched=jnp.asarray(matched2, jnp.int32),
            last_frame=fr,
        )
        self._record(pose, False, t)
        return pose

    def _record(self, pose_cw, lost: bool, t: float):
        self._trajectory.append(
            (t, np.asarray(pose_cw) if pose_cw is not None else np.eye(4), lost)
        )
