"""Left-right stereo matching: sub-pixel disparity for every left keypoint.

Vectorized rebuild of `Frame::ComputeStereoMatches`
(`/root/reference/src/Frame.cc:584-756`). The reference walks a per-row
candidate table sequentially; here the whole (left x right) candidate
relation is one dense mask over the matmul Hamming-distance matrix, and the
SAD sub-pixel refinement runs for every accepted left keypoint as a single
batched gather + 11-shift L1 scan:

  stage 1  row-band / octave / disparity-range mask  (Frame.cc:592-665)
           best Hamming match < TH_HIGH over the masked distance matrix
  stage 2  SAD sliding window, w=5, L=5, center-subtracted patches at the
           left keypoint's pyramid level, parabola sub-pixel (Frame.cc:
           668-721)
  stage 3  accept 0 <= disparity < maxD (= bf/minZ with minZ = baseline,
           i.e. maxD = fx); median-based outlier trim
           thDist = 1.5*1.4*median(SAD) (Frame.cc:742-755)

Deviation (documented): the reference's strip-bounds test uses
`iniu = scaleduR0 + L - w` (`Frame.cc:690`), an apparent sign slip that
under-rejects near the left border; we bound the full strip
[suR0-L-w, suR0+L+w] instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import hamming, orb

SAD_W = 5  # half window (Frame.cc:678)
SAD_L = 5  # half search range (Frame.cc:685)
_WIN = 2 * SAD_W + 1  # 11
_STRIP = _WIN + 2 * SAD_L  # 21


def stack_pyramid(spec: orb.ORBSpec, image: jax.Array) -> jax.Array:
    """(L, H0+2E, W0+2E) f32 — every padded level zero-extended to the
    level-0 footprint so per-keypoint patch gathers index one array."""
    levels = orb.build_pyramid(spec, image)
    h0, w0 = levels[0].shape
    out = []
    for lv in levels:
        out.append(jnp.pad(lv, ((0, h0 - lv.shape[0]), (0, w0 - lv.shape[1]))))
    return jnp.stack(out)


def _gather_strip(pyr: jax.Array, lvl: jax.Array, row: jax.Array,
                  col: jax.Array, width: int) -> jax.Array:
    """(11, width) window from pyramid level `lvl` centered at (row, col)
    (level-local, pre-pad coordinates). One keypoint; vmapped by callers."""

    def one(args):
        lvl, row, col = args
        return jax.lax.dynamic_slice(
            pyr[lvl],
            (row + orb.EDGE - SAD_W, col + orb.EDGE - (width - 1) // 2),
            (_WIN, width),
        )

    return one((lvl, row, col))


def compute_stereo_matches(
    spec: orb.ORBSpec,
    image_left: jax.Array, image_right: jax.Array,
    kpl_xy: jax.Array, kpl_octave: jax.Array, kpl_bits: jax.Array,
    kpl_valid: jax.Array,
    kpr_xy: jax.Array, kpr_octave: jax.Array, kpr_bits: jax.Array,
    kpr_valid: jax.Array,
    bf: float, fx: float,
):
    """Returns (ur (N,), depth (N,)) for the left keypoints; -1 where no
    stereo match (mvuRight/mvDepth init, `Frame.cc:586-587`)."""
    n_levels = spec.n_levels
    scale_factors = jnp.asarray(
        [spec.scale_factor**i for i in range(n_levels)], jnp.float32)
    inv_scale = 1.0 / scale_factors
    max_d = fx  # maxD = mbf/minZ, minZ = mb  (Frame.cc:612-614)
    min_d = -3.0  # Frame.cc:613

    ul, vl = kpl_xy[:, 0], kpl_xy[:, 1]
    ur_, vr_ = kpr_xy[:, 0], kpr_xy[:, 1]

    # ---- stage 1: masked Hamming best match --------------------------
    r_band = 2.0 * scale_factors[jnp.clip(kpr_octave, 0)]  # Frame.cc:603
    row_ok = jnp.abs(vl[:, None] - vr_[None, :]) <= r_band[None, :]
    oct_ok = (kpr_octave[None, :] >= (kpl_octave - 1)[:, None]) & (
        kpr_octave[None, :] <= (kpl_octave + 1)[:, None]
    )
    u_ok = (ur_[None, :] >= (ul - max_d)[:, None]) & (
        ur_[None, :] <= (ul - min_d)[:, None]
    )
    mask = row_ok & oct_ok & u_ok & kpl_valid[:, None] & kpr_valid[None, :]
    dmat = hamming.hamming_matrix_bits(kpl_bits, kpr_bits)
    best_r, best_d, _ = hamming.masked_best2(dmat, extra_mask=mask)
    cand = kpl_valid & (best_d < hamming.TH_HIGH)  # Frame.cc:668

    # ---- stage 2: SAD sliding window at the left keypoint's level ----
    pyr_l = stack_pyramid(spec, image_left.astype(jnp.float32))
    pyr_r = stack_pyramid(spec, image_right.astype(jnp.float32))
    lvl = jnp.clip(kpl_octave, 0, n_levels - 1)
    inv = inv_scale[lvl]
    su_l = jnp.round(ul * inv).astype(jnp.int32)
    sv_l = jnp.round(vl * inv).astype(jnp.int32)
    ur0 = ur_[jnp.clip(best_r, 0)]
    su_r0 = jnp.round(ur0 * inv).astype(jnp.int32)

    lvl_w = jnp.asarray([ls.width for ls in spec.levels], jnp.int32)[lvl]
    lvl_h = jnp.asarray([ls.height for ls in spec.levels], jnp.int32)[lvl]
    in_b = (
        (su_l - SAD_W >= 0) & (su_l + SAD_W < lvl_w)
        & (sv_l - SAD_W >= 0) & (sv_l + SAD_W < lvl_h)
        & (su_r0 - SAD_L - SAD_W >= 0) & (su_r0 + SAD_L + SAD_W < lvl_w)
    )
    cand = cand & in_b
    safe = cand  # clipped gathers are safe anyway; in_b guards semantics
    del safe

    patch_l = jax.vmap(
        lambda a, b, c: _gather_strip(pyr_l, a, b, c, _WIN)
    )(lvl, sv_l, su_l)  # (N,11,11)
    strip_r = jax.vmap(
        lambda a, b, c: _gather_strip(pyr_r, a, b, c, _STRIP)
    )(lvl, sv_l, su_r0)  # (N,11,21)

    il = patch_l - patch_l[:, SAD_W, SAD_W][:, None, None]
    # 11 shifted windows, each center-subtracted (Frame.cc:699-703)
    dists = []
    for i in range(2 * SAD_L + 1):
        w = strip_r[:, :, i:i + _WIN]
        w = w - w[:, SAD_W, SAD_W][:, None, None]
        dists.append(jnp.sum(jnp.abs(il - w), axis=(1, 2)))
    sad = jnp.stack(dists, axis=1)  # (N, 11)
    best_inc = jnp.argmin(sad, axis=1).astype(jnp.int32)  # 0..10, center 5
    interior = (best_inc > 0) & (best_inc < 2 * SAD_L)  # Frame.cc:706-707
    i0 = jnp.clip(best_inc, 1, 2 * SAD_L - 1)
    nr = jnp.arange(sad.shape[0])
    d1 = sad[nr, i0 - 1]
    d2 = sad[nr, i0]
    d3 = sad[nr, i0 + 1]
    denom = 2.0 * (d1 + d3 - 2.0 * d2)
    delta = jnp.where(jnp.abs(denom) > 1e-9, (d1 - d3) / denom, 2.0)
    delta_ok = (delta >= -1.0) & (delta <= 1.0)  # Frame.cc:717-718
    best_ur = scale_factors[lvl] * (
        su_r0.astype(jnp.float32) + (i0 - SAD_L).astype(jnp.float32) + delta
    )
    disparity = ul - best_ur
    disp_ok = (disparity >= 0) & (disparity < max_d)  # Frame.cc:728
    # disparity<=0 clamp (Frame.cc:730-734)
    best_ur = jnp.where(disparity <= 0, ul - 0.01, best_ur)
    disparity = jnp.maximum(disparity, 0.01)

    ok = cand & interior & delta_ok & disp_ok
    sad_best = d2

    # ---- stage 3: median SAD trim (Frame.cc:742-755) ------------------
    n_ok = jnp.sum(ok.astype(jnp.int32))
    sorted_sad = jnp.sort(jnp.where(ok, sad_best, jnp.inf))
    median = sorted_sad[jnp.clip(n_ok // 2, 0, sad_best.shape[0] - 1)]
    th_dist = 1.5 * 1.4 * median
    ok = ok & (sad_best < th_dist)

    ur_out = jnp.where(ok, best_ur, -1.0)
    depth = jnp.where(ok, bf / disparity, -1.0)
    return ur_out, depth
