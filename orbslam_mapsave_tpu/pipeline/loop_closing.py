"""Loop detection and correction.

`LoopClosing` thread parity (`src/LoopClosing.cc`, SURVEY.md §3.4), as host
orchestration over jitted kernels:

- `DetectLoop` (`:104-230`): 10-KF refractory period (`:115`), minScore =
  min BoW score over the query's covisibles (`:125-139`), database
  candidates (vocab/database.py), covisibility-consistency chaining with
  threshold 3 (`:153-226`, `mnCovisibilityConsistencyTh` `:43`);
- `ComputeSim3` (`:232-401`): >= 20 descriptor matches (`:268`), RANSAC
  Sim3 (ops/sim3solver.py, 300 hyp, fix_scale for stereo/RGB-D),
  `SearchBySim3` guided extension th=7.5 (`:324`), `OptimizeSim3` >= 20
  inliers (`:327-331`), Scw projection search over the loop neighbourhood
  th=10 accepting >= 40 total matched features (`:376-386`);
- `CorrectLoop` (`:403-583`): Sim3 propagation to the covisible window
  (`:436-467`), point re-mapping (`:469-499`), loop-point fusion of the
  matched features (`:516-533`), `SearchAndFuse` over the corrected window
  (`:585-611`), essential-graph optimization (optim/pose_graph.py), then a
  global-BA job (pipeline/gba.py — the reference's 4th thread `:571-575`)
  applied asynchronously with correction propagation.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import projection, se3
from ..ops import hamming, matching, sim3solver
from ..optim import pose_graph, sim3_opt
from ..slammap import mapstate as ms
from ..vocab import database, vocabulary
from . import gba as gba_mod
from . import local_mapping

CONSISTENCY_TH = 3  # LoopClosing.cc:43
REFRACTORY_KFS = 10  # LoopClosing.cc:115
LOOP_PT_CAP = 4096  # loop-neighbourhood point window for fusion
DETECT_TOP = 8  # candidates fetched per detection (one device round trip)
SIM3_TRY = 3  # enough-consistent candidates geometrically verified per
# detection — the reference round-robins ALL of them
# (`src/LoopClosing.cc:232-302`); 3 lanes cover the observed candidate
# counts while keeping the vmapped chain's cost bounded
FUSE_WINDOW = 24  # window KFs fused/reconnected at a loop event (the
# reference walks current + ALL covisibles, `src/LoopClosing.cc:432`;
# capped to the top covisibles so the correction program has a static,
# bounded fuse cost)
EDGE_CAP_PER_KF = 16  # essential-graph edge capacity = 16 * K (spanning +
# loop + covis>=100 edges; overflow edges are dropped by compaction order)


@jax.jit
def _detect_device(store: database.SparseBowStore, state: ms.MapState,
                   q_word: jax.Array, q_weight: jax.Array, kf: jax.Array):
    """The whole DetectLoop device side in ONE program: minScore over the
    query's covisibles (`LoopClosing.cc:125-139`), gated candidates
    (`KeyFrameDatabase::DetectLoopCandidates`), top-N by score, and each
    candidate's covisibility group row. One fetch replaces the 5-6
    synchronized transfers of the naive host translation."""
    covis_r = ms.covisible_keyframes(state, kf, 30)
    sc = database.sparse_score_rows(store, jnp.clip(covis_r, 0),
                                    q_word, q_weight)
    has = covis_r >= 0
    min_score = jnp.min(jnp.where(has, sc, jnp.inf))
    min_score = jnp.where(jnp.isfinite(min_score), min_score, 0.0)
    keep, scores = database.detect_loop_candidates_sparse(
        store, state, q_word, q_weight, kf, min_score)
    cs = jnp.where(keep, scores, -jnp.inf)
    top_s, top_ids = jax.lax.top_k(cs, DETECT_TOP)
    groups = state.covis[top_ids] > 0  # (DETECT_TOP, K)
    return top_ids.astype(jnp.int32), top_s, groups, has.any()


@dataclasses.dataclass
class LoopEvent:
    query_kf: int
    match_kf: int
    n_inliers: int


class LoopCloser:
    """Host driver for loop closing; `process(state, kf)` is the Run-loop
    body (`src/LoopClosing.cc:58-89`)."""

    def __init__(self, cam: projection.Camera, inv_level_sigma2,
                 voc: vocabulary.Vocabulary | None,
                 fix_scale: bool = True, enable_gba: bool = True,
                 gba_iters: int = 10, scale_factors=None,
                 n_levels: int = 4, scale_factor: float = 1.5):
        self.cam = cam
        self.voc = voc
        self.fix_scale = fix_scale
        self.enable_gba = enable_gba
        self.gba_iters = gba_iters
        # numpy closure constants (trace-time literals — see
        # geometry.projection.Camera docstring)
        self.inv_level_sigma2 = np.asarray(inv_level_sigma2, np.float32)
        self.level_sigma2 = (1.0 / self.inv_level_sigma2).astype(np.float32)
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.scale_factors = np.asarray(
            scale_factors if scale_factors is not None
            else [scale_factor**i for i in range(n_levels)], np.float32)
        self.bounds = projection.compute_image_bounds(cam)
        self.bow_store = None
        self.transform = None
        if voc is not None:
            # packed-descriptor tree descent + sparse per-KF BoW rows: both
            # sized for the real 1M-word ORBvoc (VERDICT r1 item 9)
            self.transform = vocabulary.make_transform_packed(voc)
        self.last_loop_kf = -REFRACTORY_KFS - 1
        self.consistent_groups: list[tuple[set, int]] = []
        self.events: list[LoopEvent] = []
        self.pending_gba: gba_mod.GBAJob | None = None
        self._correct_device = None  # jitted correction program (lazy)
        self._essential_device = None  # jitted pose-graph program (lazy)
        self._sim3_device = None  # jitted ComputeSim3 program (lazy)
        self._sim3_multi_device = None  # vmapped multi-candidate variant
        self._bow_one = None  # jitted per-KF BoW program (lazy)
        self._bow_add_one = None  # jitted BoW + store-insert program (lazy)
        self._pending_detect = None  # (kf, device future) awaiting fetch
        self._pending_sim3 = None  # (kf, cand, device future) awaiting fetch

    # -- BoW bookkeeping ---------------------------------------------------
    def _ensure_store(self, state: ms.MapState):
        if self.bow_store is None and self.voc is not None:
            m = min(state.n_features, max(self.voc.n_words, 1))
            self.bow_store = database.empty_sparse_store(
                state.kf_capacity, m
            )
            # keep the jitted _bow_one across resets: rebuilding the
            # wrapper forces a retrace (~1 s stall at the first post-reset
            # keyframe) for the same (m,) shape
            if getattr(self, "_bow_one_m", None) != m:
                self._bow_one = None
                self._bow_add_one = None
                self._bow_one_m = m

    def _build_bow_one(self, m: int):
        raw = self.transform.raw

        @jax.jit
        def bow_one(tables, state: ms.MapState, kf):
            out = raw(*tables, state.kf_desc[kf], state.kf_kp_valid[kf])
            return vocabulary.sparse_bow(out["word"], out["weight"], m)

        return bow_one

    def _build_bow_add_one(self, m: int):
        """compute_bow + store row insert as ONE program: the eager
        `add_keyframe_bow_sparse` pair of `.at[].set` dispatches fused
        into one launch."""
        raw = self.transform.raw

        @jax.jit
        def bow_add(tables, store: database.SparseBowStore,
                    state: ms.MapState, kf):
            out = raw(*tables, state.kf_desc[kf], state.kf_kp_valid[kf])
            w, v = vocabulary.sparse_bow(out["word"], out["weight"], m)
            store = database.SparseBowStore(
                word=store.word.at[kf].set(w[:m]),
                weight=store.weight.at[kf].set(v[:m]),
            )
            return store, w, v

        return bow_add

    def compute_bow(self, state: ms.MapState, kf: int):
        """Sparse BoW row (words, weights) for one keyframe
        (`KeyFrame::ComputeBoW`, `src/KeyFrame.cc:781-789`) — ONE jitted
        program (`sparse_bow` outside jit dispatched ~20 ops per keyframe). The vocabulary
        tables ride as ARGUMENTS (see make_transform_packed)."""
        m = self.bow_store.word.shape[1]
        if getattr(self, "_bow_one", None) is None:
            self._bow_one = self._build_bow_one(m)
        return self._bow_one(self.transform.tables, state,
                             jnp.asarray(kf, jnp.int32))

    def rebuild_store(self, state: ms.MapState) -> None:
        """Recompute BoW rows for EVERY valid keyframe of a loaded map.

        The reference rebuilds its KeyFrameDatabase after `LoadMap` by
        walking the loaded keyframes: `ComputeBoW` + `KeyFrameDatabase.add`
        (`src/System.cc:155-171`, esp. `:162-163`) — without this,
        relocalization against a loaded map only sees keyframes added
        after the load. One jitted scan over all slots; invalid slots get
        empty rows."""
        if self.voc is None:
            return
        self.bow_store = None
        self._ensure_store(state)
        raw = self.transform.raw
        m = self.bow_store.word.shape[1]
        pad = jnp.iinfo(jnp.int32).max

        @jax.jit
        def rebuild(tables, store, state):
            def body(store, kf):
                out = raw(*tables, state.kf_desc[kf], state.kf_kp_valid[kf])
                w, v = vocabulary.sparse_bow(out["word"], out["weight"], m)
                live = state.kf_valid[kf]
                w = jnp.where(live, w, pad)
                v = jnp.where(live, v, 0.0)
                return database.SparseBowStore(
                    word=store.word.at[kf].set(w),
                    weight=store.weight.at[kf].set(v),
                ), None

            store, _ = jax.lax.scan(
                body, store, jnp.arange(state.kf_capacity, dtype=jnp.int32))
            return store

        self.bow_store = rebuild(self.transform.tables, self.bow_store, state)

    # -- main entry --------------------------------------------------------
    def process(self, state: ms.MapState, kf: int) -> ms.MapState:
        """The LoopClosing::Run body for one keyframe. Detection runs
        ASYNCHRONOUSLY: the retrieval program is enqueued now and its
        (tiny) result fetched on the NEXT keyframe — by then the device
        queue has drained, so the fetch no longer stalls the pipeline.
        The one-keyframe lag mirrors the reference's detached LoopClosing
        thread, which also trails the mapper by its queue depth
        (`src/LoopClosing.cc:58-89`)."""
        if self.voc is None:
            return state
        self._ensure_store(state)
        if getattr(self, "_bow_add_one", None) is None:
            self._bow_add_one = self._build_bow_add_one(
                self.bow_store.word.shape[1])
        self.bow_store, *bow = self._bow_add_one(
            self.transform.tables, self.bow_store, state,
            jnp.asarray(kf, jnp.int32))
        state = self.poll_detect(state)
        # slot allocation is monotone, so the slot id bounds the KF count
        # without a device fetch (LoopClosing.cc:114-120 refractory gates)
        if kf - self.last_loop_kf < REFRACTORY_KFS or kf < 11:
            return state
        fut = _detect_device(self.bow_store, state, bow[0], bow[1],
                             jnp.asarray(kf))
        self._pending_detect = (kf, fut)
        return state

    def poll_detect(self, state: ms.MapState) -> ms.MapState:
        """Consume pending detection/Sim3 stages.

        Both the retrieval AND the Sim3-chain programs are fetched one
        keyframe AFTER they were enqueued: at the fetch point the device
        queue has drained, so neither sync stalls the pipeline, and a loop
        event's device work splits across TWO tracking fetch windows
        (detect+Sim3 | correct+essential+GBA) instead of piling into one.
        This is the reference's detached-LoopClosing-thread lag
        (`src/LoopClosing.cc:58-89`) made explicit."""
        state = self._poll_sim3(state)
        if self._pending_detect is None:
            return state
        kf, fut = self._pending_detect
        self._pending_detect = None
        if kf - self.last_loop_kf < REFRACTORY_KFS:
            return state  # a loop closed in the meantime
        cands = self._detect_host(kf, fut)
        if not cands:
            return state
        if self._sim3_device is None:
            self._sim3_device = self._build_sim3_device()
        # the reference tries EVERY enough-consistent candidate
        # (`LoopClosing::ComputeSim3` round-robins the candidate set until
        # one matches, `src/LoopClosing.cc:232-302`); here the whole chain
        # is vmapped over up to SIM3_TRY candidate lanes in one program and
        # the best accepting lane is selected on device
        cands = cands[:SIM3_TRY]
        if len(cands) == 1:
            # single-candidate fast path: the 1-lane program (multi-lane
            # vmap costs ~SIM3_TRY x the device time)
            fut2 = self._sim3_device(
                state, jnp.asarray(kf, jnp.int32),
                jnp.asarray(cands[0], jnp.int32), jax.random.PRNGKey(kf))
            self._pending_sim3 = (kf, np.asarray(cands, np.int32), fut2)
            return state
        pad = np.full(SIM3_TRY, cands[0], np.int32)
        pad[: len(cands)] = cands
        fut2 = self._sim3_multi(
            state, jnp.asarray(kf, jnp.int32), jnp.asarray(pad),
            jnp.asarray(np.arange(SIM3_TRY) < len(cands)),
            jax.random.PRNGKey(kf))
        self._pending_sim3 = (kf, pad, fut2)
        return state

    def _sim3_multi(self, state, kf, cands, cand_ok, key):
        """Vmapped Sim3 chain over the candidate lanes + device-side
        selection of the best accepting lane."""
        if self._sim3_multi_device is None:
            run = self._sim3_device

            @jax.jit
            def multi(state, kf, cands, cand_ok, key):
                keys = jax.random.split(key, cands.shape[0])
                outs = jax.vmap(
                    lambda c, k: run(state, kf, c, k))(cands, keys)
                total = jnp.sum((outs["matched_pt"] >= 0).astype(jnp.int32),
                                axis=-1)
                score = jnp.where(outs["accept"] & cand_ok, total, -1)
                best = jnp.argmax(score).astype(jnp.int32)
                sel = jax.tree.map(lambda x: x[best], outs)
                sel["accept"] = sel["accept"] & cand_ok[best]
                sel["which"] = best
                return sel

            self._sim3_multi_device = multi
        return self._sim3_multi_device(state, kf, cands, cand_ok, key)

    def _poll_sim3(self, state: ms.MapState) -> ms.MapState:
        """Fetch an enqueued Sim3-chain result; on acceptance, run the
        correction on the CURRENT map state (`CorrectLoop`'s snapshot lag —
        the reference's loop thread also corrects a map that tracking and
        mapping have extended since detection)."""
        if self._pending_sim3 is None:
            return state
        kf, cands, fut = self._pending_sim3
        self._pending_sim3 = None
        if kf - self.last_loop_kf < REFRACTORY_KFS:
            return state
        out = jax.device_get(fut)
        if not bool(out["accept"]):
            return state
        cand = int(cands[int(out.get("which", 0))])  # 1-lane path: lane 0
        # both endpoints must still be live on the CURRENT state — a
        # keyframe culled during the one-keyframe fetch lag would leave the
        # correction anchored on a soft-deleted pose/covis row (mirrors the
        # reference's isBad() re-checks, `src/LoopClosing.cc:245-251`)
        kf_valid = np.asarray(state.kf_valid)
        if not (bool(kf_valid[kf]) and bool(kf_valid[cand])):
            return state
        S_cur_loop = out["S12"]
        matched_pt = np.asarray(out["matched_pt"])
        loop_pts = np.asarray(out["loop_pts"])
        self.events.append(LoopEvent(kf, cand, int(out["n2"])))
        self.last_loop_kf = kf
        self.consistent_groups.clear()
        return self._correct_loop(state, kf, cand, S_cur_loop,
                                  matched_pt, loop_pts)

    # -- DetectLoop --------------------------------------------------------
    def _detect_host(self, kf: int, fut) -> list[int]:
        """Consistency chaining (`LoopClosing.cc:153-226`); returns the
        enough-consistent candidates, strongest score first (the
        reference's mvpEnoughConsistentCandidates — ALL of them proceed to
        geometric verification, `src/LoopClosing.cc:232-302`)."""
        top_ids, top_s, groups, has_covis = jax.device_get(fut)
        if not bool(has_covis):
            return []
        live = np.isfinite(top_s)
        cand_slots = top_ids[live]
        if len(cand_slots) == 0:
            self.consistent_groups.clear()
            return []
        new_groups: list[tuple[set, int]] = []
        enough: list[int] = []
        scores = {}
        for c, s, grow in zip(cand_slots, top_s[live], groups[live]):
            group = {int(c)} | {int(x) for x in np.nonzero(grow)[0]}
            scores[int(c)] = float(s)
            consistency = 0
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    consistency = max(consistency, prev_count + 1)
            new_groups.append((group, consistency))
            if consistency >= CONSISTENCY_TH:
                enough.append(int(c))
        self.consistent_groups = new_groups
        return sorted(enough, key=lambda c: -scores[c])

    # -- ComputeSim3 -------------------------------------------------------
    def _per_feature_points(self, state: ms.MapState, kf: int):
        """Gather each feature's point data (world pos, distance band,
        distinctive descriptor bits) aligned to the feature axis."""
        pts = state.kf_kp_point[kf]
        ok = state.kf_kp_valid[kf] & (pts >= 0)
        safe = jnp.clip(pts, 0)
        ok = ok & state.pt_valid[safe]
        return dict(
            ids=pts, ok=ok,
            world=state.pt_pos[safe],
            mind=0.8 * state.pt_min_dist[safe],
            maxd=1.2 * state.pt_max_dist[safe],
            bits=hamming.unpack_bits(state.pt_desc[safe]),
        )

    def _build_sim3_device(self):
        """The whole ComputeSim3 chain (`src/LoopClosing.cc:232-401`) as ONE
        jitted program with STATIC shapes.

        The round-2 host orchestration compacted the match set with
        `np.nonzero` — a different match count at every candidate meant a
        fresh RANSAC/Sim3-LM compile per loop event plus ~10 synchronizing
        fetches. Here every stage
        runs over fixed feature-aligned (N,) lanes with validity masks, and
        the acceptance gates (>= 20 matches, RANSAC ok, >= 20 Sim3 inliers,
        >= 40 total) come back as flags in one fetch."""
        cam = self.cam
        fix_scale = self.fix_scale
        bounds = self.bounds
        scale_factors = self.scale_factors
        n_levels = self.n_levels
        scale_factor = self.scale_factor
        level_sigma2 = self.level_sigma2

        @jax.jit
        def run(state: ms.MapState, kf, cand, key):
            level_sigma2 = jnp.asarray(self.level_sigma2)
            N = state.n_features
            P = state.pt_capacity
            b1 = hamming.unpack_bits(state.kf_desc[kf])
            b2 = hamming.unpack_bits(state.kf_desc[cand])
            f1 = self._per_feature_points(state, kf)
            f2 = self._per_feature_points(state, cand)
            matches, n = matching.search_by_descriptor(
                b1, f1["ok"], b2, f2["ok"],
                state.kf_kp_angle[kf], state.kf_kp_angle[cand],
                th=hamming.TH_LOW, nn_ratio=0.75,
            )
            ok_n = n >= 20  # LoopClosing.cc:268
            # feature-aligned RANSAC lanes: row i of KF1 matches row
            # matches[i] of KF2 (invalid lanes masked)
            m_ok = matches >= 0
            m_safe = jnp.clip(matches, 0)
            T1 = state.kf_pose[kf]
            T2 = state.kf_pose[cand]
            pc1 = se3.transform_points(T1, f1["world"])
            pc2 = se3.transform_points(T2, f2["world"][m_safe])
            uv1 = state.kf_kp_xy[kf]
            uv2 = state.kf_kp_xy[cand][m_safe]
            nl = level_sigma2.shape[0]
            o1 = jnp.clip(state.kf_kp_octave[kf], 0, nl - 1)
            o2 = jnp.clip(state.kf_kp_octave[cand][m_safe], 0, nl - 1)
            me1 = sim3solver.CHI2_SIM3 * level_sigma2[o1]
            me2 = sim3solver.CHI2_SIM3 * level_sigma2[o2]
            S12, inl, n_inl, ok_ransac = sim3solver.ransac_sim3(
                key, pc1, pc2, uv1, uv2, 300, fix_scale,
                max_err1=me1, max_err2=me2, valid=m_ok,
                fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                min_inliers=20,
            )

            # guided extension (`SearchBySim3`, ORBmatcher.cc:1105-1329)
            match12 = jnp.where(m_ok & inl, matches, -1)
            already1 = match12 >= 0
            already2 = jnp.zeros(N, bool).at[jnp.clip(match12, 0)].max(
                already1)
            extra12, _ = matching.search_by_sim3(
                cam, T1, T2, S12,
                state.kf_kp_xy[kf], state.kf_kp_octave[kf], b1,
                state.kf_kp_valid[kf], f1["world"], f1["ok"], f1["mind"],
                f1["maxd"], f1["bits"],
                state.kf_kp_xy[cand], state.kf_kp_octave[cand], b2,
                state.kf_kp_valid[cand], f2["world"], f2["ok"], f2["mind"],
                f2["maxd"], f2["bits"],
                already1, already2,
                bounds, scale_factors, th=7.5,
                n_levels=n_levels, scale_factor=scale_factor,
            )
            match12 = jnp.where(match12 >= 0, match12,
                                jnp.where(extra12 >= 0, extra12, -1))

            # Sim3 optimization over the extended set (OptimizeSim3)
            e_ok = match12 >= 0
            e_safe = jnp.clip(match12, 0)
            o2e = jnp.clip(state.kf_kp_octave[cand][e_safe], 0, nl - 1)
            obs = sim3_opt.Sim3Obs(
                pc1=pc1,
                pc2=se3.transform_points(T2, f2["world"][e_safe]),
                uv1=uv1,
                uv2=state.kf_kp_xy[cand][e_safe],
                inv_sigma2_1=1.0 / level_sigma2[o1],
                inv_sigma2_2=1.0 / level_sigma2[o2e],
                valid=e_ok,
            )
            S12_opt, inl2, n2 = sim3_opt.optimize_sim3(
                cam, S12, obs, fix_scale)
            ok_n2 = n2 >= 20  # LoopClosing.cc:327-331

            # matched loop point per current-KF feature
            matched_pt = jnp.where(e_ok & inl2,
                                   f2["ids"][e_safe], -1).astype(jnp.int32)

            # mScw = gScm * gSmw (:333-336)
            Scw = S12_opt @ T2

            # loop-neighbourhood points (mvpLoopMapPoints, :353-374):
            # points of cand + its covisibles, compacted to LOOP_PT_CAP
            neigh = ms.covisible_keyframes(state, cand, ms.MAX_OBS)
            rows = jnp.concatenate(
                [cand[None].astype(jnp.int32),
                 jnp.where(neigh >= 0, neigh, cand)])
            row_ok = jnp.concatenate([jnp.asarray([True]), neigh >= 0])
            pts_rows = jnp.where(row_ok[:, None],
                                 state.kf_kp_point[rows], -1)
            flat = pts_rows.reshape(-1)
            flag = jnp.zeros(P, jnp.int8).at[jnp.clip(flat, 0)].max(
                jnp.where(flat >= 0, jnp.int8(1), jnp.int8(0)))
            flag = jnp.where(state.pt_valid, flag, 0)
            loop_pts = ms.compact_indices(flag, min(LOOP_PT_CAP, P))
            has_loop_pts = jnp.any(loop_pts >= 0)

            # Scw projection search over the loop points (:376-386)
            lp = jnp.clip(loop_pts, 0)
            matched_flag = jnp.zeros(P, bool).at[
                jnp.clip(matched_pt, 0)].max(matched_pt >= 0)
            lp_ok = (loop_pts >= 0) & state.pt_valid[lp] & ~matched_flag[lp]
            proj, _ = matching.search_by_projection_scw(
                cam, Scw,
                state.pt_pos[lp], lp_ok,
                0.8 * state.pt_min_dist[lp], 1.2 * state.pt_max_dist[lp],
                state.pt_normal[lp], hamming.unpack_bits(state.pt_desc[lp]),
                state.kf_kp_xy[kf], state.kf_kp_octave[kf], b1,
                state.kf_kp_valid[kf], matched_pt >= 0,
                bounds, scale_factors, th=10.0,
                n_levels=n_levels, scale_factor=scale_factor,
            )
            matched_pt = jnp.where(
                (matched_pt < 0) & (proj >= 0),
                loop_pts[jnp.clip(proj, 0)], matched_pt)

            total = jnp.sum((matched_pt >= 0).astype(jnp.int32))
            accept = ok_n & ok_ransac & ok_n2 & has_loop_pts & (total >= 40)
            return dict(accept=accept, S12=S12_opt, n2=n2,
                        matched_pt=matched_pt, loop_pts=loop_pts)

        return run

    def _compute_sim3(self, state: ms.MapState, kf: int, cand: int):
        if self._sim3_device is None:
            self._sim3_device = self._build_sim3_device()
        out = jax.device_get(self._sim3_device(
            state, jnp.asarray(kf, jnp.int32), jnp.asarray(cand, jnp.int32),
            jax.random.PRNGKey(kf)))
        if not bool(out["accept"]):
            return None
        return (out["S12"], cand, int(out["n2"]),
                np.asarray(out["matched_pt"]), np.asarray(out["loop_pts"]))

    # -- CorrectLoop -------------------------------------------------------
    def _build_correct_device(self):
        """One jitted program for the whole loop correction
        (`src/LoopClosing.cc:403-583` minus pose graph/GBA): Sim3
        propagation to the covisible window, point re-mapping, matched-
        feature fusion, SearchAndFuse + UpdateConnections over the window,
        loop-edge insertion. The round-2 host version dispatched ~70 small
        programs with numpy fetches between them."""
        cam = self.cam
        bounds = self.bounds
        scale_factors = self.scale_factors
        inv_ls2 = self.inv_level_sigma2
        n_levels = self.n_levels
        scale_factor = self.scale_factor

        @jax.jit
        def correct(state: ms.MapState, kf, match_kf, S_cl, matched_pt,
                    loop_pts):
            K = state.kf_capacity
            P = state.pt_capacity
            # the Sim3 chain ran one keyframe earlier (deferred fetch);
            # re-validate its point slots against the CURRENT state (a
            # mapping pass may have culled some in between — slots are
            # monotone so there is no aliasing, only soft-deletion)
            matched_pt = jnp.where(
                (matched_pt >= 0) & state.pt_valid[jnp.clip(matched_pt, 0)],
                matched_pt, -1)
            loop_pts = jnp.where(
                (loop_pts >= 0) & state.pt_valid[jnp.clip(loop_pts, 0)],
                loop_pts, -1)
            poses = state.kf_pose
            # window = current KF + its covisibles (:432)
            wmask = (state.covis[kf] > 0) & state.kf_valid
            wmask = wmask.at[kf].set(True)
            # corrected Sim3 per window KF: S_ik @ (gScm @ Smw) (:436-467)
            S_corr_cur = S_cl @ poses[match_kf]
            S_ik = poses @ se3.se3_inv(poses[kf])  # (K,4,4) relative, scale 1
            corr = S_ik @ S_corr_cur  # (K,4,4) corrected Scw (Sim3)
            # point correction through the FIRST window observer (:469-499).
            # Window membership tested against a bitmask and poses selected
            # by one-hot contraction instead of (P,O) gathers from (K,)
            # tables (optim/global_ba._onehot_po).
            obs_kf = state.pt_obs_kf
            n_words = (K + 31) // 32
            ids_k = jnp.arange(K, dtype=jnp.int32)
            words = jnp.zeros(n_words, jnp.int32).at[ids_k >> 5].max(
                jnp.where(wmask, 1 << (ids_k & 31), 0))
            po_safe = jnp.clip(obs_kf, 0)
            bit = jnp.zeros(obs_kf.shape, jnp.int32)
            for wi in range(n_words):
                bit = bit | jnp.where((po_safe >> 5) == wi,
                                      (words[wi] >> (po_safe & 31)) & 1, 0)
            in_win = (obs_kf >= 0) & (bit > 0)
            has = in_win.any(-1) & state.pt_valid
            first_lane = jnp.argmax(in_win, -1)
            lane_ids = jnp.arange(obs_kf.shape[1], dtype=jnp.int32)
            ref = jnp.sum(jnp.where(lane_ids[None, :] == first_lane[:, None],
                                    obs_kf, 0), axis=-1)
            safe_ref = jnp.clip(ref, 0)
            oh_ref = (safe_ref[:, None] == ids_k).astype(jnp.float32)
            from ..optim import lm as lm_mod

            S_old = jnp.einsum("pk,kf->pf", oh_ref, poses.reshape(K, 16),
                               precision=lm_mod.HI).reshape(P, 4, 4)
            S_new_inv = jnp.einsum(
                "pk,kf->pf", oh_ref, se3.sim3_inv(corr).reshape(K, 16),
                precision=lm_mod.HI).reshape(P, 4, 4)
            p_cam = jnp.einsum("pij,pj->pi", S_old[:, :3, :3],
                               state.pt_pos) + S_old[:, :3, 3]
            p_new = jnp.einsum("pij,pj->pi", S_new_inv[:, :3, :3], p_cam) \
                + S_new_inv[:, :3, 3]
            pt_pos = jnp.where(has[:, None], p_new, state.pt_pos)
            # corrected poses folded back to SE3 (:459-467)
            s_w, R_w, t_w = se3.sim3_split(corr)
            T_w = se3.rt_to_mat(R_w, t_w / s_w[..., None])
            kf_pose = jnp.where(wmask[:, None, None], T_w, poses)
            state = state._replace(pt_pos=pt_pos, kf_pose=kf_pose)

            # matched-feature fusion on the current KF (:516-533)
            N = state.n_features
            existing = state.kf_kp_point[kf]
            has_match = matched_pt >= 0
            merge = has_match & (existing >= 0) & (existing != matched_pt)
            src = jnp.where(merge, existing, -1)
            dst = jnp.where(merge, matched_pt, -1)
            state = ms.merge_points(state, src, dst, merge)
            feat = jnp.arange(N, dtype=jnp.int32)
            add = has_match & (state.kf_kp_point[kf] < 0)
            state = ms.add_observations(state, kf, matched_pt, feat, add)
            state = ms.compute_distinctive_descriptors_idx(
                state, jnp.clip(matched_pt, 0), add)

            # SearchAndFuse + UpdateConnections over the top-FUSE_WINDOW
            # window KFs (:585-611, :544-562), sequential inside the program
            w = jnp.where(wmask, state.covis[kf], -1).at[kf].set(1 << 30)
            _, win_kfs = jax.lax.top_k(w, min(FUSE_WINDOW, K))
            win_ok = jnp.take_along_axis(
                w, win_kfs, 0) > 0

            def fuse_body(i, st):
                k = win_kfs[i]

                def do(st):
                    st = local_mapping.fuse_into_keyframe(
                        st, k, loop_pts, cam, bounds, scale_factors,
                        inv_ls2, n_levels, scale_factor,
                        th=4.0, prefer_candidate=True,
                    )
                    return ms.update_connections(st, k)

                return jax.lax.cond(win_ok[i], do, lambda s: s, st)

            state = jax.lax.fori_loop(0, win_kfs.shape[0], fuse_body, state)

            # loop edge (:567-570): first free lane on each side
            le = state.kf_loop_edges
            free1 = jnp.argmax(le[kf] < 0)
            free2 = jnp.argmax(le[match_kf] < 0)
            state = state._replace(
                kf_loop_edges=le.at[kf, free1].set(match_kf)
                .at[match_kf, free2].set(kf)
            )
            return state

        return correct

    def _correct_loop(self, state: ms.MapState, kf: int, match_kf: int,
                      S_cur_loop: jax.Array, matched_pt: np.ndarray,
                      loop_pts: np.ndarray) -> ms.MapState:
        """Sim3 propagation + loop fusion + pose graph + GBA job
        (`src/LoopClosing.cc:403-583`)."""
        if self._correct_device is None:
            self._correct_device = self._build_correct_device()
        lp_pad = np.full(min(LOOP_PT_CAP, int(state.pt_capacity)), -1,
                         np.int64)
        lp_pad[: min(len(loop_pts), len(lp_pad))] = loop_pts[: len(lp_pad)]
        state = self._correct_device(
            state, jnp.asarray(kf, jnp.int32), jnp.asarray(match_kf, jnp.int32),
            jnp.asarray(S_cur_loop, jnp.float32),
            jnp.asarray(matched_pt.astype(np.int32)),
            jnp.asarray(lp_pad.astype(np.int32)),
        )

        # essential-graph optimization (:565)
        state = self._essential_graph(state, kf, match_kf)

        # global BA as an async job (the reference's GBA thread, :571-575);
        # a still-pending job from a previous loop is aborted (:409-427)
        if self.enable_gba:
            if self.pending_gba is not None:
                self.pending_gba.abort()
            self.pending_gba = gba_mod.GBAJob(
                state, self.cam, self.inv_level_sigma2,
                n_iters=self.gba_iters, robust=False,
            )
        return state

    def remap_keyframes(self, new_of_old) -> None:
        """Apply a keyframe-slot compaction permutation
        (`mapstate.compact_keyframes`) to the BoW store and the detector's
        host-side bookkeeping."""
        import numpy as _np

        # a pending detection's/Sim3's kf slot and store rows are stale
        # after compaction: drop them (one missed retrieval, like a queue
        # reset)
        self._pending_detect = None
        self._pending_sim3 = None
        if self.bow_store is not None:
            old_ids = _np.nonzero(new_of_old >= 0)[0]
            new_ids = new_of_old[old_ids]
            word = np.asarray(self.bow_store.word)
            weight = np.asarray(self.bow_store.weight)
            nw = np.full_like(word, np.iinfo(np.int32).max)
            nv = np.zeros_like(weight)
            nw[new_ids] = word[old_ids]
            nv[new_ids] = weight[old_ids]
            self.bow_store = database.SparseBowStore(
                word=jnp.asarray(nw), weight=jnp.asarray(nv))
        remap = {int(o): int(n) for o, n in
                 zip(*[_np.nonzero(new_of_old >= 0)[0],
                       new_of_old[new_of_old >= 0]])}
        self.consistent_groups = [
            ({remap[g] for g in grp if g in remap}, c)
            for grp, c in self.consistent_groups
        ]
        self.consistent_groups = [(g, c) for g, c in self.consistent_groups
                                  if g]
        if self.last_loop_kf >= 0:
            self.last_loop_kf = remap.get(self.last_loop_kf,
                                          -REFRACTORY_KFS - 1)

    def poll_gba(self, state: ms.MapState,
                 force: bool = False) -> ms.MapState:
        """Pump the incremental GBA job (a couple of LM-iteration enqueues
        per call — the host owns the loop boundary, so an abort() between
        polls stops issuing and reclaims the remaining device time), and
        apply it once every iteration is issued (the reference joins the
        GBA thread and propagates corrections, `LoopClosing.cc:643-786`).
        force=True finishes all remaining iterations now (shutdown/save
        paths, `isFinishedGBA` blocking in `src/System.cc:535-550`)."""
        if self.pending_gba is None:
            return state
        job = self.pending_gba
        if force:
            job.finish()
        else:
            job.pump(max_iters=2)
        if not job.done:
            return state
        self.pending_gba = None
        return job.apply(state)

    def _build_essential_device(self):
        """One jitted program: device-side edge extraction (STATIC edge
        capacity — the round-2 host `np.nonzero` produced a different edge
        count at every loop event, recompiling the pose-graph program
        per event) + 20-iteration Sim3
        pose graph + point correction."""

        @jax.jit
        def run(state: ms.MapState, kf, match_kf):
            K = state.kf_capacity
            E_CAP = EDGE_CAP_PER_KF * K
            valid = state.kf_valid
            ids = jnp.arange(K, dtype=jnp.int32)
            # symmetric edge mask: spanning tree + loop edges + covis>=100
            # + the current loop pair (`src/Optimizer.cc:781-1062`)
            mask = (state.covis >= ms.ESSENTIAL_MIN_WEIGHT)
            par = state.kf_parent
            pe = (par >= 0) & valid & valid[jnp.clip(par, 0)]
            mask = mask.at[ids, jnp.clip(par, 0)].max(pe)
            le = state.kf_loop_edges  # (K,E)
            le_ok = le >= 0
            rows = jnp.broadcast_to(ids[:, None], le.shape)
            mask = mask.at[rows, jnp.clip(le, 0)].max(le_ok)
            mask = mask.at[kf, match_kf].set(True)
            mask = mask | mask.T
            mask = mask & valid[:, None] & valid[None, :]
            mask = mask & (ids[:, None] < ids[None, :])  # upper triangle
            # compact the (K,K) mask into E_CAP static edge lanes
            flat = mask.reshape(-1)
            pos = jnp.cumsum(flat.astype(jnp.int32)) - flat
            okp = flat & (pos < E_CAP)
            lin = jnp.arange(K * K, dtype=jnp.int32)
            buf = jnp.full(E_CAP, -1, jnp.int32).at[
                jnp.where(okp, pos, E_CAP - 1)
            ].max(jnp.where(okp, lin, -1), mode="drop")
            e_ok = buf >= 0
            ei = jnp.where(e_ok, buf // K, 0)
            ej = jnp.where(e_ok, buf % K, 0)
            poses = state.kf_pose
            meas = poses[ei] @ se3.se3_inv(poses[ej])
            fixed = jnp.zeros(K, bool).at[match_kf].set(True)  # Optimizer.cc:820
            prob = pose_graph.PoseGraphProblem(
                S_init=poses,
                fixed=fixed,
                valid=valid,
                edge_i=ei,
                edge_j=ej,
                edge_meas=meas,
                edge_valid=e_ok,
                edge_weight=jnp.ones(E_CAP, jnp.float32),
            )
            # reference-scale maps switch to the matrix-free CG form: the
            # dense (7K,7K) assembly is O(E*K^2) flops per LM iteration
            S_opt, _ = pose_graph.optimize_pose_graph(
                prob, n_iters=20,
                solver="dense" if K <= 384 else "cg")
            # correct points through reference KFs (Optimizer.cc:1031-1060);
            # one-hot pose selection (see _onehot_po rationale)
            from ..optim import lm as lm_mod

            refs = state.pt_ref_kf
            safe_ref = jnp.clip(refs, 0, K - 1)
            oh_ref = (safe_ref[:, None] == ids).astype(jnp.float32)
            P_ = state.pt_capacity
            S_old_ref = jnp.einsum(
                "pk,kf->pf", oh_ref, poses.reshape(K, 16),
                precision=lm_mod.HI).reshape(P_, 4, 4)
            S_new_ref = jnp.einsum(
                "pk,kf->pf", oh_ref, S_opt.reshape(K, 16),
                precision=lm_mod.HI).reshape(P_, 4, 4)
            p_new = pose_graph.correct_points(state.pt_pos, S_old_ref,
                                              S_new_ref)
            upd = state.pt_valid & (refs >= 0)
            return state._replace(
                pt_pos=jnp.where(upd[:, None], p_new, state.pt_pos),
                kf_pose=jnp.where(valid[:, None, None],
                                  pose_graph.sim3_to_se3(S_opt),
                                  state.kf_pose),
            )

        return run

    def _essential_graph(self, state: ms.MapState, kf: int, match_kf: int):
        """Essential-graph pose relaxation (`Optimizer::OptimizeEssentialGraph`,
        `src/Optimizer.cc:781-1062`): spanning-tree edges + loop edges +
        covisibility edges with weight >= 100, the matched KF fixed."""
        if self._essential_device is None:
            self._essential_device = self._build_essential_device()
        return self._essential_device(
            state, jnp.asarray(kf, jnp.int32), jnp.asarray(match_kf, jnp.int32))
