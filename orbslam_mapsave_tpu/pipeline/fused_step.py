"""One-program-per-frame fused tracking (+ conditional mapping) step.

The reference interleaves tracking and mapping through threads and mutexes
(`src/Tracking.cc:541-741`, `src/LocalMapping.cc:47-112`); every branch of
its per-frame state machine is a host decision. On an accelerator, where
every host<->device round trip stalls the device queue, that structure is
the wrong shape: this module compiles the
ENTIRE per-frame pipeline into a single XLA program:

    motion-model track  ->  (widen / reference-KF fallback via lax.cond)
    -> local-map track  ->  keyframe decision (`NeedNewKeyFrame`,
    `src/Tracking.cc:1224-1321`, evaluated on device)
    -> predicated keyframe creation
    -> predicated LocalMapping pass (triangulation scan + local BA + culls)

The host never reads a scalar in the steady state; it enqueues one program
per frame and fetches small `StepOutcome` records in batches. Mode changes
(LOST -> relocalization, monocular bootstrap) are the only host-mediated
paths, and they are rare by construction.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..slammap import mapstate as ms
from . import frame as frame_mod
from . import tracking as trk

MODE_NOT_INITIALIZED = 1
MODE_OK = 2
MODE_LOST = 3


class ControlState(NamedTuple):
    """Device-resident tracker state (the members of `Tracking`
    (`include/Tracking.h:85-228`) that the per-frame loop reads/writes)."""

    mode: jax.Array  # () i32
    pose: jax.Array  # (4,4) f32 last Tcw
    velocity: jax.Array  # (4,4) f32 motion model
    has_velocity: jax.Array  # () bool
    ref_kf: jax.Array  # () i32
    frame_id: jax.Array  # () i32 — id of the NEXT frame to process
    last_kf_frame_id: jax.Array  # () i32
    last_matched: jax.Array  # (N,) i32 point slot per last-frame feature
    last_frame: frame_mod.FrameData
    recent_start: jax.Array  # () i32 — mapper recent-point window start
    allow_kf: jax.Array  # () bool — False in localization-only mode
    mb_vo: jax.Array  # () bool — map-less visual odometry (Tracking.cc:595-640)


class StepOutcome(NamedTuple):
    mode: jax.Array  # () i32 tracker mode AFTER the frame
    pose: jax.Array  # (4,4) f32 Tcw (garbage when lost)
    n_inliers: jax.Array  # () i32
    kf_created: jax.Array  # () bool
    kf_slot: jax.Array  # () i32
    n_kf: jax.Array  # () i32 keyframes alive after the frame
    n_pt: jax.Array  # () i32 point slots allocated (allocator watermark)
    n_kf_alloc: jax.Array  # () i32 keyframe slots allocated (watermark)
    mb_vo: jax.Array  # () bool — host retries relocalization while set
    ba_lanes_dropped: jax.Array  # () i32 in-window BA obs lanes truncated
    # this step even after escalation (0 on non-keyframe frames)
    ba_escalated: jax.Array  # () bool — BA rebuilt at O_BA_ESC lanes


def initial_control_state(n_features: int, dummy_frame: frame_mod.FrameData
                          ) -> ControlState:
    return ControlState(
        mode=jnp.asarray(MODE_NOT_INITIALIZED, jnp.int32),
        pose=jnp.eye(4, dtype=jnp.float32),
        velocity=jnp.eye(4, dtype=jnp.float32),
        has_velocity=jnp.asarray(False),
        ref_kf=jnp.asarray(0, jnp.int32),
        frame_id=jnp.asarray(0, jnp.int32),
        last_kf_frame_id=jnp.asarray(0, jnp.int32),
        last_matched=jnp.full((n_features,), -1, jnp.int32),
        last_frame=dummy_frame,
        recent_start=jnp.asarray(0, jnp.int32),
        allow_kf=jnp.asarray(True),
        mb_vo=jnp.asarray(False),
    )


def make_fused_step(cam, builder: frame_mod.FrameBuilder, n_levels: int,
                    scale_factor: float, cfg: trk.TrackerConfig,
                    mapper=None):
    """Build the jitted per-frame step.

    Returns step(map_state, ctrl, frame) -> (map_state, ctrl, outcome).
    `mapper`: a `LocalMapper` whose pass runs INSIDE the program (predicated
    on keyframe creation), or None to leave mapping to the host.
    """
    k = trk.make_tracking_kernels(cam, builder, n_levels, scale_factor)
    is_mono = cfg.is_mono
    N = None  # bound at trace time

    def _empty_matched(n):
        return jnp.full((n,), -1, jnp.int32)

    def _need_new_keyframe(state, frame, matched, n_inl, ref_kf, ctrl):
        """`Tracking::NeedNewKeyFrame` — THIS FORK's formula
        (`src/Tracking.cc:1224-1321`): the map-coverage ratio
        ratioMap = (close features holding an observed map point) /
        (all close features) drives insertion — ratioMap < 0.35 (0.20 when
        inliers > 300) fires c2, ratioMap < 0.3 fires the weak-tracking
        c1c. This is what keeps keyframes coming while the camera turns
        into unmapped territory (round 1 shipped upstream ORB-SLAM2's older
        tracked_close<100 & nontracked>70 rule, which only fires after
        near-total inlier decay — keyframe starvation)."""
        ninl_i = n_inl
        if is_mono:
            ratio_map = jnp.asarray(1.0)  # "no VO matches in mono" (:1270)
        else:
            close = frame.valid & (frame.kp_depth > 0) & (
                frame.kp_depth < cfg.th_depth
            )
            ok_pt = (matched >= 0) & state.pt_valid[jnp.clip(matched, 0)]
            has_obs = (state.pt_obs_kf[jnp.clip(matched, 0)] >= 0).any(-1)
            n_map = jnp.sum((close & ok_pt & has_obs).astype(jnp.int32))
            n_total = jnp.sum(close.astype(jnp.int32))
            ratio_map = n_map.astype(jnp.float32) / jnp.maximum(
                n_total.astype(jnp.float32), 1.0)
        th_map_ratio = jnp.where(ninl_i > 300, 0.20, 0.35)  # :1285-1287
        n_kfs = jnp.sum(state.kf_valid.astype(jnp.int32))
        th_ref = jnp.where(n_kfs < 2, 0.4, 0.9 if is_mono else 0.75)
        # reference KF match count = points with >= nMinObs observations
        # (`mpReferenceKF->TrackedMapPoints(nMinObs)`, `src/Tracking.cc:
        # 1243-1246`, nMinObs=3 once the map has >2 KFs). Counting every
        # point here (including the fresh single-observation ones each new
        # KF seeds) inflates the threshold so a keyframe fires EVERY frame,
        # ballooning the map with duplicates and corrupting local BA.
        ref_pts = state.kf_kp_point[ref_kf]
        ref_has = (ref_pts >= 0) & state.kf_kp_valid[ref_kf]
        n_obs_ref = jnp.sum(
            (state.pt_obs_kf[jnp.clip(ref_pts, 0)] >= 0).astype(jnp.int32),
            axis=-1,
        )
        min_obs = jnp.where(n_kfs <= 2, 2, 3)
        ref_matches = jnp.sum(
            (ref_has & (n_obs_ref >= min_obs)).astype(jnp.int32)
        )
        # bootstrap: right after (stereo/RGB-D) initialization every map
        # point has ONE observation, so TrackedMapPoints(2) is 0 and the
        # ratio conditions can never fire — the second keyframe would wait
        # for the 1-second c1a timer while tracking decays. Fall back to
        # the all-points count until multi-observation points exist.
        ref_all = jnp.sum(ref_has.astype(jnp.int32))
        ref_matches = jnp.where(ref_matches > 0, ref_matches, ref_all)
        c1a = ctrl.frame_id >= ctrl.last_kf_frame_id + cfg.max_frames
        c1b = ctrl.frame_id >= ctrl.last_kf_frame_id + cfg.min_frames
        rm = ref_matches.astype(jnp.float32)
        ninl = n_inl.astype(jnp.float32)
        if is_mono:
            c1c = jnp.asarray(False)  # :1291 mono excluded
        else:
            c1c = (ninl < rm * 0.25) | (ratio_map < 0.3)
        c2 = ((ninl < rm * th_ref) | (ratio_map < th_map_ratio)) & (n_inl > 15)
        cap_ok = state.n_kf < state.kf_capacity - 1
        return (c1a | c1b | c1c) & c2 & cap_ok & ctrl.allow_kf

    def _track_ok(state, ctrl, frame):
        """The OK-mode pipeline (`Tracking::Track`, `src/Tracking.cc:575-640`)."""
        n = frame.kp_xy.shape[0]
        pose_pred = ctrl.velocity @ ctrl.pose
        only_tracking = ~ctrl.allow_kf  # localization mode (mbOnlyTracking)

        def motion_track(_):
            m, pw, have, nm = k["track_motion"](
                state, frame, pose_pred, ctrl.last_matched, ctrl.last_frame,
                jnp.asarray(cfg.motion_th, jnp.float32), ctrl.pose,
                only_tracking)

            def widen(_):
                return k["track_motion"](
                    state, frame, pose_pred, ctrl.last_matched,
                    ctrl.last_frame,
                    jnp.asarray(2.0 * cfg.motion_th, jnp.float32),
                    ctrl.pose, only_tracking)

            m, pw, have, nm = jax.lax.cond(
                nm < 20, widen, lambda _: (m, pw, have, nm), None)

            def opt(_):
                pose, mm, ninl, nmap = k["optimize_pose_xyz"](
                    state, frame, pose_pred, pw, have, m)
                # SLAM mode: >= 10 map inliers; localization mode: the
                # temporal-point odometry passes with > 20 total inliers
                # and flags mbVO when the MAP matches collapse
                # (`src/Tracking.cc:1160-1174,612-615`)
                ok = jnp.where(only_tracking, ninl > 20, nmap >= 10)
                vo = only_tracking & (nmap < 10) & (ninl > 20)
                return ok, pose, mm, vo

            return jax.lax.cond(
                nm >= 20, opt,
                lambda _: (jnp.asarray(False), pose_pred, m,
                           jnp.asarray(False)), None)

        def no_motion(_):
            return (jnp.asarray(False), ctrl.pose, _empty_matched(n),
                    jnp.asarray(False))

        ok_m, pose_m, m_m, vo_m = jax.lax.cond(ctrl.has_velocity,
                                               motion_track, no_motion, None)

        def keep(_):
            return ok_m, pose_m, m_m, vo_m

        def refkf_track(_):
            m, nm = k["track_ref_kf"](state, frame, ctrl.ref_kf)

            def opt(_):
                pose, mm, ninl = k["optimize_pose"](state, frame, ctrl.pose, m)
                return (ninl >= 10), pose, mm, jnp.asarray(False)

            return jax.lax.cond(
                nm >= 15, opt,
                lambda _: (jnp.asarray(False), ctrl.pose, m,
                           jnp.asarray(False)), None)

        ok1, pose1, m1, use_vo = jax.lax.cond(ok_m, keep, refkf_track, None)

        # ---- local-map tracking (runs even if initial track failed: it
        # cannot rescue ok1=False because matched is empty then). In
        # map-less VO mode it has nothing to match — the reference skips
        # TrackLocalMap when mbVO (`src/Tracking.cc:654-660`); here the
        # outcome is simply not gated on its inlier count. ----
        local_idx, ref2 = k["gather_local_map"](state, m1, pose1)
        state2, pose2, m2, n_inl = k["track_local_map"](
            state, frame, pose1, m1, local_idx,
            jnp.asarray(cfg.local_th, jnp.float32))
        ok2 = ok1 & (use_vo | (n_inl >= 30))  # Tracking.cc:1213-1219
        pose2 = jnp.where(use_vo, pose1, pose2)
        m2 = jnp.where(use_vo, m1, m2)
        state2 = jax.tree.map(
            lambda new, old: jnp.where(ok1 & ~use_vo, new, old), state2, state)

        need_kf = _need_new_keyframe(state2, frame, m2, n_inl, ref2, ctrl)

        def create(st):
            if is_mono:
                st3, kf = k["create_keyframe_mono"](st, frame, pose2, m2,
                                                    ctrl.frame_id)
                return st3, kf, m2
            st3, kf, m3 = k["create_keyframe_rgbd"](
                st, frame, pose2, m2, ctrl.frame_id,
                jnp.asarray(cfg.th_depth, jnp.float32))
            return st3, kf, m3

        def no_create(st):
            return st, jnp.asarray(-1, jnp.int32), m2

        do_kf = ok2 & need_kf
        state3, kf_slot, m3 = jax.lax.cond(do_kf, create, no_create, state2)

        # ---- predicated LocalMapping pass ----
        recent_start = ctrl.recent_start
        ba_dropped = jnp.asarray(0, jnp.int32)
        ba_esc = jnp.asarray(False)
        if mapper is not None:
            n_pt_before = state3.n_pt
            # mbAbortBA analogue (`src/LocalMapping.cc:118`,
            # `src/Optimizer.cc:517-518`): in the reference, a keyframe
            # arriving while local BA runs aborts it after the current
            # round. Keyframes spaced <= 2 frames apart imply exactly that
            # pressure, so truncate BA to its first phase for them.
            abort_ba = (ctrl.frame_id - ctrl.last_kf_frame_id) <= 2

            def run_map(st):
                return mapper._map_step(
                    st, kf_slot, ctrl.recent_start, abort_ba)

            state3, ba_dropped, ba_esc = jax.lax.cond(
                do_kf, run_map,
                lambda st: (st, ba_dropped, ba_esc), state3)
            recent_start = jnp.where(do_kf, n_pt_before, recent_start)

        vel = pose2 @ se3.se3_inv(ctrl.pose)
        new_mode = jnp.where(ok2, MODE_OK, MODE_LOST).astype(jnp.int32)
        ctrl2 = ControlState(
            mode=new_mode,
            pose=jnp.where(ok2, pose2, ctrl.pose),
            velocity=jnp.where(ok2, vel, jnp.eye(4, dtype=jnp.float32)),
            has_velocity=ok2,
            ref_kf=jnp.where(do_kf, kf_slot, ref2).astype(jnp.int32),
            frame_id=ctrl.frame_id + 1,
            last_kf_frame_id=jnp.where(do_kf, ctrl.frame_id,
                                       ctrl.last_kf_frame_id),
            last_matched=m3,
            last_frame=frame,
            recent_start=recent_start,
            allow_kf=ctrl.allow_kf,
            mb_vo=ok2 & use_vo,
        )
        out = StepOutcome(
            mode=new_mode, pose=pose2, n_inliers=n_inl,
            kf_created=do_kf, kf_slot=kf_slot,
            n_kf=jnp.sum(state3.kf_valid.astype(jnp.int32)),
            n_pt=state3.n_pt,
            n_kf_alloc=state3.n_kf,
            mb_vo=ok2 & use_vo,
            ba_lanes_dropped=ba_dropped,
            ba_escalated=ba_esc,
        )
        return state3, ctrl2, out

    def _init_rgbd(state, ctrl, frame):
        """`Tracking::StereoInitialization` (`src/Tracking.cc:750-802`),
        predicated on the feature count."""
        n = frame.kp_xy.shape[0]
        n_feat = jnp.sum(frame.valid.astype(jnp.int32))

        def do(_):
            st, kf, matched, n_pts = k["init_rgbd"](state, frame,
                                                    ctrl.frame_id)
            ctrl2 = ControlState(
                mode=jnp.asarray(MODE_OK, jnp.int32),
                pose=jnp.eye(4, dtype=jnp.float32),
                velocity=jnp.eye(4, dtype=jnp.float32),
                has_velocity=jnp.asarray(False),
                ref_kf=kf.astype(jnp.int32),
                frame_id=ctrl.frame_id + 1,
                last_kf_frame_id=ctrl.frame_id,
                last_matched=matched,
                last_frame=frame,
                recent_start=ctrl.recent_start,
                allow_kf=ctrl.allow_kf,
                mb_vo=jnp.asarray(False),
            )
            out = StepOutcome(
                mode=ctrl2.mode, pose=jnp.eye(4, dtype=jnp.float32),
                n_inliers=n_pts, kf_created=jnp.asarray(True),
                kf_slot=kf.astype(jnp.int32),
                n_kf=jnp.sum(st.kf_valid.astype(jnp.int32)), n_pt=st.n_pt,
                n_kf_alloc=st.n_kf,
                mb_vo=jnp.asarray(False),
                ba_lanes_dropped=jnp.asarray(0, jnp.int32),
                ba_escalated=jnp.asarray(False),
            )
            return st, ctrl2, out

        def skip(_):
            ctrl2 = ctrl._replace(
                frame_id=ctrl.frame_id + 1, last_frame=frame,
                last_matched=_empty_matched(n))
            out = StepOutcome(
                mode=ctrl.mode, pose=jnp.eye(4, dtype=jnp.float32),
                n_inliers=jnp.asarray(0, jnp.int32),
                kf_created=jnp.asarray(False),
                kf_slot=jnp.asarray(-1, jnp.int32),
                n_kf=jnp.sum(state.kf_valid.astype(jnp.int32)),
                n_pt=state.n_pt,
                n_kf_alloc=state.n_kf,
                mb_vo=jnp.asarray(False),
                ba_lanes_dropped=jnp.asarray(0, jnp.int32),
                ba_escalated=jnp.asarray(False),
            )
            return state, ctrl2, out

        return jax.lax.cond(n_feat >= cfg.min_init_features, do, skip, None)

    def _lost(state, ctrl, frame):
        """LOST passthrough: the host mediates relocalization
        (`Tracking::Relocalization`, `src/Tracking.cc:1601-1775`)."""
        n = frame.kp_xy.shape[0]
        ctrl2 = ctrl._replace(
            frame_id=ctrl.frame_id + 1, last_frame=frame,
            last_matched=_empty_matched(n), has_velocity=jnp.asarray(False),
            mb_vo=jnp.asarray(False))
        out = StepOutcome(
            mode=ctrl.mode, pose=ctrl.pose,
            n_inliers=jnp.asarray(0, jnp.int32),
            kf_created=jnp.asarray(False),
            kf_slot=jnp.asarray(-1, jnp.int32),
            n_kf=jnp.sum(state.kf_valid.astype(jnp.int32)),
            n_pt=state.n_pt,
            n_kf_alloc=state.n_kf,
            mb_vo=jnp.asarray(False),
            ba_lanes_dropped=jnp.asarray(0, jnp.int32),
            ba_escalated=jnp.asarray(False),
        )
        return state, ctrl2, out

    @jax.jit
    def step(state: ms.MapState, ctrl: ControlState,
             frame: frame_mod.FrameData):
        branches = [
            _init_rgbd if not is_mono else _lost,  # NOT_INITIALIZED
            _track_ok,  # OK
            _lost,  # LOST
        ]
        idx = jnp.clip(ctrl.mode - MODE_NOT_INITIALIZED, 0, 2)
        return jax.lax.switch(idx, branches, state, ctrl, frame)

    del N
    return step
