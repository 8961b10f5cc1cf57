"""Hamming descriptor distance as a matmul + matching primitives.

Replaces the reference's scalar SWAR popcount loop
(`ORBmatcher::DescriptorDistance`, `src/ORBmatcher.cc:1650-1666`) with a
bit-plane matmul identity: for 0/1 bit vectors a, b

    hamming(a,b) = popcount(a) + popcount(b) - 2 * dot(a, b)

so an entire (Na x Nb) distance matrix is one int8 matmul instead of
Na*Nb*8 scalar popcounts. Rotation-consistency voting mirrors the
30-bin histogram + top-3 filter of `src/ORBmatcher.cc:39,1604-1645`.

Thresholds carried from the reference: TH_HIGH=100, TH_LOW=50
(`src/ORBmatcher.cc:37-38`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30

# sentinel distance for invalid entries — a PYTHON int on purpose:
# `jnp.int32(...)` at module level is a device array, and jitted closures
# capture only trace-time literals (see projection.Camera docstring)
_BIG = 1 << 20


def unpack_bits(desc: jax.Array) -> jax.Array:
    """(N,32) uint8 -> (N,256) int8 bit-planes (LSB-first per byte)."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (desc[..., :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(desc.shape[0], 256).astype(jnp.int8)


def pack_bits(bits: jax.Array) -> jax.Array:
    """(N,256) {0,1} -> (N,32) uint8, LSB-first."""
    b = bits.reshape(bits.shape[0], 32, 8).astype(jnp.uint32)
    weights = (1 << jnp.arange(8, dtype=jnp.uint32))
    return jnp.sum(b * weights, axis=-1).astype(jnp.uint8)


def hamming_matrix(desc_a: jax.Array, desc_b: jax.Array) -> jax.Array:
    """Full pairwise Hamming distances (Na,Nb) int32 from (N,32) uint8.

    The inner product runs as an int8 x int8 -> int32 matmul (cuBLAS on the GPU;
    256 bit-planes are the contraction depth).
    """
    a = unpack_bits(desc_a)
    b = unpack_bits(desc_b)
    return hamming_matrix_bits(a, b)


def hamming_matrix_bits(a: jax.Array, b: jax.Array) -> jax.Array:
    """Pairwise Hamming from pre-unpacked (N,256) int8 bit-planes."""
    pa = jnp.sum(a.astype(jnp.int32), axis=-1)
    pb = jnp.sum(b.astype(jnp.int32), axis=-1)
    dot = jax.lax.dot_general(
        a, b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return pa[:, None] + pb[None, :] - 2 * dot


def hamming_vec(desc_a: jax.Array, desc_b: jax.Array) -> jax.Array:
    """Elementwise Hamming distance between aligned rows (N,32)x(N,32)->(N,)."""
    x = jnp.bitwise_xor(desc_a, desc_b)
    return jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)


def masked_best2(dist: jax.Array, valid_b: jax.Array | None = None,
                 extra_mask: jax.Array | None = None):
    """Per-row best and second-best over a distance matrix (Na,Nb).

    Returns (best_idx (Na,), best_dist, second_dist). Entries excluded by
    `valid_b` (Nb,) or `extra_mask` (Na,Nb boolean, True=allowed) get the
    _BIG sentinel. Mirrors the bestDist/bestDist2 pattern used throughout
    `ORBmatcher` (e.g. `src/ORBmatcher.cc:472-507`).
    """
    d = dist
    if valid_b is not None:
        d = jnp.where(valid_b[None, :], d, _BIG)
    if extra_mask is not None:
        d = jnp.where(extra_mask, d, _BIG)
    # best + runner-up via two masked min-reductions: `lax.top_k(d, 2)`
    # lowers to a FULL variadic sort of every row;
    # argmin + re-min is three cheap element-wise passes
    best = jnp.min(d, axis=1)
    idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    cols = jnp.arange(d.shape[1], dtype=jnp.int32)
    second = jnp.min(jnp.where(cols[None, :] == idx[:, None], _BIG, d),
                     axis=1)
    return idx, best, second


def mutual_best(dist: jax.Array, valid_a: jax.Array | None,
                valid_b: jax.Array | None):
    """Cross-check matching: i<->j kept only if argmin both ways agrees."""
    d = dist
    if valid_a is not None:
        d = jnp.where(valid_a[:, None], d, _BIG)
    if valid_b is not None:
        d = jnp.where(valid_b[None, :], d, _BIG)
    best_ab = jnp.argmin(d, axis=1)
    best_ba = jnp.argmin(d, axis=0)
    ok = best_ba[best_ab] == jnp.arange(d.shape[0])
    return best_ab, jnp.min(d, axis=1), ok


def rotation_consistency_mask(angles_a: jax.Array, angles_b_matched: jax.Array,
                              match_ok: jax.Array) -> jax.Array:
    """Rotation-histogram filter (`src/ORBmatcher.cc:1604-1645`).

    Quirk preserved from the reference: `bin = round(rot * 1/HISTO_LENGTH)`
    (`src/ORBmatcher.cc:175,244` — rot/30, NOT rot*30/360), so only bins
    0..12 are ever populated, each 30 degrees wide. Keeps matches in the
    top-3 bins, dropping bins 2 and 3 unless they hold >= 0.1 * max
    (`ComputeThreeMaxima`, `src/ORBmatcher.cc:1636-1644`).
    """
    factor = 1.0 / HISTO_LENGTH
    rot = angles_a - angles_b_matched
    rot = jnp.where(rot < 0, rot + 360.0, rot)
    bins = jnp.round(rot * factor).astype(jnp.int32)
    bins = jnp.where(bins == HISTO_LENGTH, 0, bins)
    bins = jnp.clip(bins, 0, HISTO_LENGTH - 1)
    counts = jnp.zeros(HISTO_LENGTH, jnp.int32).at[bins].add(
        match_ok.astype(jnp.int32)
    )
    top3_vals, top3_idx = jax.lax.top_k(counts, 3)
    max1 = top3_vals[0]
    keep1 = top3_idx[0]
    keep2 = jnp.where(top3_vals[1] >= (0.1 * max1).astype(jnp.int32), top3_idx[1], -1)
    keep3 = jnp.where(top3_vals[2] >= (0.1 * max1).astype(jnp.int32), top3_idx[2], -1)
    in_top = (bins == keep1) | (bins == keep2) | (bins == keep3)
    return match_ok & in_top
