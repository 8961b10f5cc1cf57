"""Keyframe database: BoW retrieval for loop detection and relocalization.

`KeyFrameDatabase` parity (`src/KeyFrameDatabase.cc`, SURVEY.md §2.1). The
reference keeps an inverted index word -> list<KeyFrame*> and walks lists
per query word (`DetectLoopCandidates`, `:151-272`). Dense design:
BoW vectors live as a dense (K, W) matrix, so

- common-word counts = boolean matmul (query>0) . (bow>0)^T;
- L1 similarity scores for ALL keyframes = one matmul;
- the reference's gates run as masked reductions: minCommonWords =
  0.8 * maxCommonWords (`:195,315`), minScore floor (loop only),
  covisibility-group score accumulation over top-10 covisibles with the
  0.75 * bestAccScore cut (`:227-258,342-380`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..optim import lm as lm_mod
from ..slammap import mapstate as ms

_PAD = jnp.iinfo(jnp.int32).max  # sparse-row pad (keeps rows sorted)


def empty_bow_store(max_keyframes: int, n_words: int) -> jax.Array:
    return jnp.zeros((max_keyframes, n_words), jnp.float32)


def add_keyframe_bow(store: jax.Array, kf_slot, bow: jax.Array) -> jax.Array:
    """`KeyFrameDatabase::add` (`:115-121`)."""
    return store.at[kf_slot].set(bow)


def erase_keyframe_bow(store: jax.Array, kf_slot) -> jax.Array:
    """`KeyFrameDatabase::erase` (`:123-142`)."""
    return store.at[kf_slot].set(0.0)


def _common_words_and_scores(store: jax.Array, query: jax.Array):
    common = jax.lax.dot_general(
        (store > 0).astype(jnp.float32), (query > 0).astype(jnp.float32),
        (((1,), (0,)), ((), ())), precision=lm_mod.HI,
    )  # (K,)
    # L1 score vs all rows: 1 - 0.5*sum|a-b|
    scores = 1.0 - 0.5 * jnp.sum(jnp.abs(store - query[None, :]), axis=-1)
    return common.astype(jnp.int32), scores


@jax.jit
def detect_loop_candidates(store: jax.Array, state: ms.MapState,
                           query_bow: jax.Array, query_kf,
                           min_score: jax.Array):
    """`DetectLoopCandidates` (`src/KeyFrameDatabase.cc:151-272`).

    Excludes the query's covisible neighbours; gates: common words >
    0.8*max, score >= minScore, then accumulated covisibility-group score
    (top-10 covisibles of each candidate) with the 0.75*bestAccScore cut.
    Returns (candidate_mask (K,), scores (K,)).
    """
    K = store.shape[0]
    connected = state.covis[query_kf] > 0
    eligible = state.kf_valid & ~connected & (jnp.arange(K) != query_kf)
    common, scores = _common_words_and_scores(store, query_bow)
    common = jnp.where(eligible, common, 0)
    max_common = jnp.max(common)
    min_common = (0.8 * max_common).astype(jnp.int32)  # :195
    ok = eligible & (common > min_common) & (scores >= min_score)
    # accumulated group score over each candidate's top-10 covisibles (:227-246)
    top_w, top_kf = jax.lax.top_k(state.covis, 10)  # (K,10)
    neigh_ok = (top_w > 0) & ok[top_kf]  # neighbours that also matched
    neigh_scores = jnp.where(neigh_ok, scores[top_kf], 0.0)
    acc = jnp.where(ok, scores, 0.0) + jnp.sum(neigh_scores, -1)
    best_acc = jnp.max(jnp.where(ok, acc, -jnp.inf))
    keep = ok & (acc > 0.75 * best_acc)  # :251
    return keep, scores


# ---------------------------------------------------------------------------
# Sparse store — scales to the real 1M-word ORBvoc.
#
# The dense (K, W) matrix is O(K*W) = 2 GB at K=512, W=1e6
# (`ORBvoc`, TemplatedVocabulary.h:1471-1476). Each keyframe's BoW vector
# has at most N (= feature count) nonzero words, so the sparse store keeps
# per-KF SORTED word rows (K, M) + weights; retrieval intersects the query
# row against all K rows with ONE batched searchsorted (gathers, no
# scatters): for L1-normalized vectors the DBoW2 L1 score reduces to
# sum over shared words of min(v1_w, v2_w).
# ---------------------------------------------------------------------------


class SparseBowStore(NamedTuple):
    word: jax.Array  # (K,M) i32 sorted ascending, INT32_MAX pad
    weight: jax.Array  # (K,M) f32, 0 on pads


def empty_sparse_store(max_keyframes: int, m_words: int) -> SparseBowStore:
    return SparseBowStore(
        word=jnp.full((max_keyframes, m_words), _PAD, jnp.int32),
        weight=jnp.zeros((max_keyframes, m_words), jnp.float32),
    )


def add_keyframe_bow_sparse(store: SparseBowStore, kf_slot,
                            words: jax.Array, weights: jax.Array
                            ) -> SparseBowStore:
    """`KeyFrameDatabase::add` — rows come from `vocabulary.sparse_bow`."""
    m = store.word.shape[1]
    return SparseBowStore(
        word=store.word.at[kf_slot].set(words[:m]),
        weight=store.weight.at[kf_slot].set(weights[:m]),
    )


def erase_keyframe_bow_sparse(store: SparseBowStore, kf_slot) -> SparseBowStore:
    return SparseBowStore(
        word=store.word.at[kf_slot].set(_PAD),
        weight=store.weight.at[kf_slot].set(0.0),
    )


def _sparse_common_and_scores(store: SparseBowStore, q_word: jax.Array,
                              q_weight: jax.Array):
    """(common (K,), scores (K,)) against all rows at once.

    score = sum_shared min(v1, v2)  ==  1 - 0.5*|v1 - v2|_1 for
    L1-normalized vectors (`L1Scoring::score`, ScoringObject.cpp:23-70).

    Sorted-merge join per row: concatenate the query words onto every
    row and re-sort — shared words land adjacent, and words are unique
    within each side, so an equal-adjacent pair IS an intersection hit.
    One native (K, M+Mq) sort replaces the old vmapped `searchsorted`
    (~1.4M serialized binary-search gathers per detection)."""
    K, M = store.word.shape
    Mq = q_word.shape[0]
    # dead query entries must never match: force their word to the pad
    q_w = jnp.where(q_weight > 0, q_word, _PAD)
    words = jnp.concatenate(
        [jnp.broadcast_to(q_w[None, :], (K, Mq)), store.word], axis=1)
    vals = jnp.concatenate(
        [jnp.broadcast_to(q_weight[None, :], (K, Mq)), store.weight], axis=1)
    sw, sv = jax.lax.sort((words, vals), num_keys=1, dimension=1)
    match = (sw[:, 1:] == sw[:, :-1]) & (sw[:, 1:] != _PAD)
    contrib = jnp.minimum(sv[:, 1:], sv[:, :-1])
    common = jnp.sum(match.astype(jnp.int32), -1)
    scores = jnp.sum(jnp.where(match, contrib, 0.0), -1)
    return common, scores


@jax.jit
def detect_loop_candidates_sparse(store: SparseBowStore, state: ms.MapState,
                                  q_word: jax.Array, q_weight: jax.Array,
                                  query_kf, min_score: jax.Array):
    """Sparse twin of `detect_loop_candidates` — identical gates."""
    K = store.word.shape[0]
    connected = state.covis[query_kf] > 0
    eligible = state.kf_valid & ~connected & (jnp.arange(K) != query_kf)
    common, scores = _sparse_common_and_scores(store, q_word, q_weight)
    common = jnp.where(eligible, common, 0)
    max_common = jnp.max(common)
    min_common = (0.8 * max_common).astype(jnp.int32)  # KeyFrameDatabase.cc:195
    ok = eligible & (common > min_common) & (scores >= min_score)
    top_w, top_kf = jax.lax.top_k(state.covis, 10)
    neigh_ok = (top_w > 0) & ok[top_kf]
    neigh_scores = jnp.where(neigh_ok, scores[top_kf], 0.0)
    acc = jnp.where(ok, scores, 0.0) + jnp.sum(neigh_scores, -1)
    best_acc = jnp.max(jnp.where(ok, acc, -jnp.inf))
    keep = ok & (acc > 0.75 * best_acc)  # :251
    return keep, scores


@jax.jit
def detect_relocalization_candidates_sparse(store: SparseBowStore,
                                            state: ms.MapState,
                                            q_word: jax.Array,
                                            q_weight: jax.Array):
    """Sparse twin of `detect_relocalization_candidates` — identical gates."""
    common, scores = _sparse_common_and_scores(store, q_word, q_weight)
    common = jnp.where(state.kf_valid, common, 0)
    max_common = jnp.max(common)
    min_common = (0.8 * max_common).astype(jnp.int32)  # :315
    ok = state.kf_valid & (common > min_common)
    top_w, top_kf = jax.lax.top_k(state.covis, 10)
    neigh_ok = (top_w > 0) & ok[top_kf]
    neigh_scores = jnp.where(neigh_ok, scores[top_kf], 0.0)
    acc = jnp.where(ok, scores, 0.0) + jnp.sum(neigh_scores, -1)
    best_acc = jnp.max(jnp.where(ok, acc, -jnp.inf))
    keep = ok & (acc > 0.75 * best_acc)  # :368
    return keep, scores


@jax.jit
def sparse_score_rows(store: SparseBowStore, rows: jax.Array,
                      q_word: jax.Array, q_weight: jax.Array) -> jax.Array:
    """L1 scores of the query against selected rows (for the covisible
    minScore floor, `LoopClosing.cc:125-139`)."""
    sub = SparseBowStore(word=store.word[rows], weight=store.weight[rows])
    _, scores = _sparse_common_and_scores(sub, q_word, q_weight)
    return scores


@jax.jit
def detect_relocalization_candidates(store: jax.Array, state: ms.MapState,
                                     query_bow: jax.Array):
    """`DetectRelocalizationCandidates` (`src/KeyFrameDatabase.cc:274-391`) —
    same gating minus the covisibility exclusion and minScore floor."""
    common, scores = _common_words_and_scores(store, query_bow)
    common = jnp.where(state.kf_valid, common, 0)
    max_common = jnp.max(common)
    min_common = (0.8 * max_common).astype(jnp.int32)  # :315
    ok = state.kf_valid & (common > min_common)
    top_w, top_kf = jax.lax.top_k(state.covis, 10)
    neigh_ok = (top_w > 0) & ok[top_kf]
    neigh_scores = jnp.where(neigh_ok, scores[top_kf], 0.0)
    acc = jnp.where(ok, scores, 0.0) + jnp.sum(neigh_scores, -1)
    best_acc = jnp.max(jnp.where(ok, acc, -jnp.inf))
    keep = ok & (acc > 0.75 * best_acc)  # :368
    return keep, scores
