"""Global-BA job: snapshot, optimize, propagate corrections forward.

`LoopClosing::RunGlobalBundleAdjustment` parity (`src/LoopClosing.cc:643-786`):
the reference spawns GBA in a 4th thread over a snapshot of the map while
tracking/mapping keep extending it, then — when GBA finishes — walks the
spanning tree to push corrected poses onto keyframes created DURING the run
(`mTcwGBA = Tchildc * parent->mTcwGBA`, `:674-715`) and moves map points
created during the run through their reference keyframe's before/after poses
(`:718-776`).

Shape: the "thread" is JAX's async dispatch — `launch` enqueues
the jitted full-map BA (optim/global_ba.py) on the device and returns
immediately; the host keeps tracking. `apply` blocks on the result (the
transfer is the synchronization point) and merges it into the CURRENT map
state, propagating to everything allocated after the snapshot. Slot
allocation is monotone (`mapstate.add_keyframe/add_points`), so "created
during GBA" is exactly `slot >= snapshot count` — no id bookkeeping needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry import projection, se3
from ..optim import global_ba
from ..slammap import mapstate as ms


class GBAJob:
    """One in-flight global bundle adjustment over a map snapshot.

    On a multi-device runtime (len(jax.devices()) > 1 and capacities
    divisible by the device count) the job automatically runs the
    keyframe-block sharded solver (`parallel/dist_gba.distributed_full_ba`)
    over a device mesh — the live-system integration of SURVEY.md §5.8 /
    BASELINE's multi-host north star. Single chip falls back to the
    single-device implicit-Schur solver."""

    def __init__(self, state: ms.MapState, cam: projection.Camera,
                 inv_level_sigma2, n_iters: int = 10, robust: bool = False,
                 cg_iters: int = 100):
        self.snap_n_kf = int(state.n_kf)
        self.snap_n_pt = int(state.n_pt)
        self.snap_kf_pose = state.kf_pose  # pre-GBA poses (mTcwBefGBA)
        self.aborted = False
        self._cam = cam
        self._robust = robust
        self._cg_iters = cg_iters
        self._incremental = False
        # async dispatch: every enqueue returns device futures, not
        # results. The single-device solver picks the exact dense-Schur
        # path for live-map K (optim/global_ba._solve_dense) — cg_iters
        # only caps the PCG fallback and the sharded multi-device solver.
        # An under-capped CG (30) cost the r4 bench 0.017 m vs 0.007 m
        # keyframe ATE (tools/ate_probe.py)
        n_dev = len(jax.devices())
        if (n_dev > 1 and state.kf_capacity % n_dev == 0
                and state.pt_capacity % n_dev == 0):
            from ..parallel import dist_gba

            mesh = dist_gba.make_mesh(n_dev)
            sharded = dist_gba.shard_map_state(state, mesh)
            self.kf_pose_gba, self.pt_pos_gba, self.cost = (
                dist_gba.distributed_full_ba(
                    cam, sharded, jnp.asarray(inv_level_sigma2), mesh,
                    n_iters=n_iters, robust=robust, cg_iters=cg_iters,
                )
            )
        else:
            # INCREMENTAL: the host owns the LM loop boundary — one device
            # program per iteration, pumped from the backend drain. abort()
            # then stops issuing, reclaiming the remaining device time
            # (parity with mbStopGBA checked between LM iterations,
            # `src/LoopClosing.cc:604-631`, `src/Optimizer.cc:517-518`).
            # Solver picked from the LIVE keyframe count host-side: the
            # jit-side "auto" rule sees only the PADDED capacity
            self._incremental = True
            # memory is CAPACITY-driven (padded tables), quality/live-count
            # only picks between the affordable solvers: the dense/one-hot
            # paths carry (P,O,K) operators and (P,O,4,4) pose gathers
            # sized by capacity — at reference-scale caps they take tens of
            # GB regardless of how few keyframes are live
            oh_bytes = (state.pt_capacity * global_ba.O_GBA
                        * state.kf_capacity * 4)
            if oh_bytes >= 2 * 1024**3:
                self._solver = "pcg_dual"
            elif self.snap_n_kf <= 384:
                self._solver = "dense"
            else:
                self._solver = "pcg"
            self._tb, self._carry = global_ba.gba_init(
                cam, state, jnp.asarray(inv_level_sigma2), robust=robust,
                solver=self._solver)
            self.iters_left = n_iters

    def pump(self, max_iters: int = 1) -> bool:
        """Enqueue up to max_iters LM iteration programs (async, no
        sync — NO host fetches). Convergence is handled ON DEVICE: the
        carry's stop flag turns later iterations into pass-throughs (g2o's
        LM terminates on negligible gain too). Returns True while work
        remains."""
        if not self._incremental or self.aborted:
            return False
        while self.iters_left > 0 and max_iters > 0:
            self._carry = global_ba.gba_iterate(
                self._cam, self._tb, *self._carry, robust=self._robust,
                solver=self._solver, cg_iters=self._cg_iters)
            self.iters_left -= 1
            max_iters -= 1
        return self.iters_left > 0

    @property
    def done(self) -> bool:
        return self.aborted or not (self._incremental and self.iters_left > 0)

    def finish(self):
        """Issue all remaining iterations (used by flush paths)."""
        if self._incremental and not self.aborted:
            self.pump(max_iters=self.iters_left)

    def abort(self):
        """`mbStopGBA` analogue: stop issuing iteration programs (the
        un-issued device time is reclaimed) and drop the result."""
        self.aborted = True
        if self._incremental:
            self.iters_left = 0

    def apply(self, state: ms.MapState) -> ms.MapState:
        """Merge the finished GBA into the current (possibly grown) map.

        - keyframes with slot < snapshot: corrected pose directly
          (`pKF->mTcwGBA`, `src/LoopClosing.cc:771` region);
        - keyframes created during the run: spanning-tree propagation
          T_new = (T_old @ T_parent_old^-1) @ T_parent_new (`:697-707`);
        - points with slot < snapshot: corrected position (`:754-758`);
        - points created during the run: moved through their reference
          keyframe's before/after poses (`:760-776`).

        ONE device program instead of fetching the full map and looping
        keyframes in Python; the propagation chain is a K-step
        `fori_loop` in slot order (a parent is always allocated before
        its child), everything else is vectorized.
        """
        if self.aborted:
            return state
        if self._incremental:
            self.finish()
            poses, pts, _, self.cost, _ = self._carry
            # f32 exp()@pose chains drift off SO(3) (see se3.orthonormalize)
            self.kf_pose_gba = se3.orthonormalize(poses)
            self.pt_pos_gba = pts
        return _apply_device(
            state, self.kf_pose_gba, self.pt_pos_gba,
            jnp.asarray(self.snap_n_kf, jnp.int32),
            jnp.asarray(self.snap_n_pt, jnp.int32),
        )


@jax.jit
def _apply_device(state: ms.MapState, gba_poses: jax.Array,
                  gba_pts: jax.Array, snap_n_kf: jax.Array,
                  snap_n_pt: jax.Array) -> ms.MapState:
    K = state.kf_capacity
    cur_poses = state.kf_pose
    slots = jnp.arange(K, dtype=jnp.int32)
    in_snap = (slots < snap_n_kf) & state.kf_valid
    new_poses = jnp.where(in_snap[:, None, None], gba_poses, cur_poses)
    covered0 = in_snap
    parent = state.kf_parent
    is_new = (slots >= snap_n_kf) & state.kf_valid

    def body(k, carry):
        poses, covered = carry
        p = jnp.clip(parent[k], 0)
        ok = is_new[k] & (parent[k] >= 0) & covered[p]
        # T_child_parent from the apply-time chain, re-anchored on the
        # corrected parent (LoopClosing.cc:697-707)
        T_cp = cur_poses[k] @ se3.se3_inv(cur_poses[p])
        prop = T_cp @ poses[p]
        poses = poses.at[k].set(jnp.where(ok, prop, poses[k]))
        covered = covered.at[k].set(covered[k] | state.kf_valid[k])
        return poses, covered

    new_poses, _ = jax.lax.fori_loop(0, K, body, (new_poses, covered0))

    # points: snapshot points take GBA positions; younger points move
    # through their reference KF's before/after pair
    P = state.pt_capacity
    pslots = jnp.arange(P, dtype=jnp.int32)
    old = (pslots < snap_n_pt) & state.pt_valid
    young = (pslots >= snap_n_pt) & state.pt_valid & (state.pt_ref_kf >= 0)
    # per-point reference poses via one-hot contraction instead of a (P,)
    # row gather from the (K,4,4) table (see optim/global_ba._onehot_po)
    safe = jnp.clip(state.pt_ref_kf, 0, K - 1)
    oh = (safe[:, None] == jnp.arange(K, dtype=jnp.int32)).astype(jnp.float32)
    from ..optim import lm as lm_mod

    T_ref_old = jnp.einsum("pk,kf->pf", oh, cur_poses.reshape(K, 16),
                           precision=lm_mod.HI).reshape(P, 4, 4)
    T_ref_new = jnp.einsum("pk,kf->pf", oh, new_poses.reshape(K, 16),
                           precision=lm_mod.HI).reshape(P, 4, 4)
    p_cam = jnp.einsum("nij,nj->ni", T_ref_old[:, :3, :3],
                       state.pt_pos) + T_ref_old[:, :3, 3]
    Twc = se3.se3_inv(T_ref_new)
    p_prop = jnp.einsum("nij,nj->ni", Twc[:, :3, :3], p_cam) + Twc[:, :3, 3]
    pt_pos = jnp.where(old[:, None], gba_pts,
                       jnp.where(young[:, None], p_prop, state.pt_pos))
    return state._replace(kf_pose=new_poses, pt_pos=pt_pos)
