"""Tests for matmul Hamming matching vs direct popcount reference."""

import jax.numpy as jnp
import numpy as np

from orbslam_mapsave_tpu.ops import hamming


def _np_hamming(a, b):
    ax = np.unpackbits(a, axis=1)
    bx = np.unpackbits(b, axis=1)
    return (ax[:, None, :] != bx[None, :, :]).sum(-1)


def test_hamming_matrix_exact(rng):
    a = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (48, 32), dtype=np.uint8)
    ours = np.asarray(hamming.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    expect = _np_hamming(a, b)
    np.testing.assert_array_equal(ours, expect)


def test_hamming_vec(rng):
    a = rng.integers(0, 256, (100, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (100, 32), dtype=np.uint8)
    ours = np.asarray(hamming.hamming_vec(jnp.asarray(a), jnp.asarray(b)))
    expect = np.diagonal(_np_hamming(a, b))
    np.testing.assert_array_equal(ours, expect)


def test_pack_unpack_roundtrip(rng):
    d = rng.integers(0, 256, (16, 32), dtype=np.uint8)
    bits = hamming.unpack_bits(jnp.asarray(d))
    back = np.asarray(hamming.pack_bits(bits))
    np.testing.assert_array_equal(back, d)


def test_masked_best2(rng):
    a = rng.integers(0, 256, (10, 32), dtype=np.uint8)
    b = np.concatenate([a[5:6], rng.integers(0, 256, (19, 32), dtype=np.uint8)])
    dist = hamming.hamming_matrix(jnp.asarray(a), jnp.asarray(b))
    idx, best, second = hamming.masked_best2(dist)
    assert int(idx[5]) == 0 and int(best[5]) == 0
    assert (np.asarray(second) >= np.asarray(best)).all()
    # masking out column 0 changes row 5's best
    valid_b = np.ones(20, bool)
    valid_b[0] = False
    idx2, best2, _ = hamming.masked_best2(dist, jnp.asarray(valid_b))
    assert int(idx2[5]) != 0


def test_mutual_best(rng):
    a = rng.integers(0, 256, (8, 32), dtype=np.uint8)
    perm = rng.permutation(8)
    b = a[perm]
    dist = hamming.hamming_matrix(jnp.asarray(a), jnp.asarray(b))
    best_ab, d, ok = hamming.mutual_best(dist, None, None)
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(best_ab), np.argsort(perm))


def test_rotation_consistency_reference_binning():
    # all matches share rotation ~45deg -> bin round(45/30)=2; one outlier at
    # 180deg -> bin 6 must be dropped.
    n = 50
    ang_a = np.zeros(n, np.float32)
    ang_b = np.full(n, -45.0, np.float32)
    ang_b[0] = -180.0
    ok = np.ones(n, bool)
    keep = np.asarray(
        hamming.rotation_consistency_mask(
            jnp.asarray(ang_a), jnp.asarray(ang_b), jnp.asarray(ok)
        )
    )
    assert keep[1:].all()
    assert not keep[0]
