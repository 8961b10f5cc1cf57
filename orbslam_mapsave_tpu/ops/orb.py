"""Batched ORB pyramid feature extraction — vectorized redesign.

Replaces the reference's `ORBextractor` (`src/ORBextractor.cc:1042-1108`,
SURVEY.md §2.1) with whole-image vectorized stages instead of per-cell scalar
loops:

- pyramid: bilinear resize per level with reflect-101 borders
  (`ORBextractor::ComputePyramid`, `src/ORBextractor.cc:1110-1135`);
- FAST-9/16: the segment test evaluated for EVERY pixel at once via 16
  shifted views + doubling min-scan over circular arcs; the score is the
  max threshold at which the pixel stays a corner (OpenCV's FAST score),
  with 3x3 non-max suppression (`ComputeKeyPointsOctTree`,
  `src/ORBextractor.cc:764-852`);
- dual-threshold fallback per detection cell: cells that fire at iniThFAST
  keep only those corners, dead cells fall back to minThFAST — same
  semantics as the per-cell retry at `src/ORBextractor.cc:808-815`;
- spatial redistribution: per-cell top-k + global top-N(level) by response
  replaces the quadtree `DistributeOctTree` (`src/ORBextractor.cc:538-762`)
  with the same spatial-uniformity intent (SURVEY.md §7.3 notes this is
  behavioral, not bit-exact, parity);
- orientation: intensity-centroid over the radius-15 circular patch with the
  reference's exact umax row extents (`IC_Angle`, `src/ORBextractor.cc:76-103`,
  umax construction `452-468`);
- descriptors: 7x7 sigma=2 Gaussian blur (`src/ORBextractor.cc:1089`), then
  rotated 256-pair BRIEF with cvRound sampling parity
  (`computeOrbDescriptor`, `src/ORBextractor.cc:107-146`) — pattern data in
  `orb_pattern.py`.

All shapes are static: each level has a fixed candidate capacity and the
result is a fixed-capacity keypoint set with a validity mask.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from .orb_pattern import BIT_PATTERN_31

HALF_PATCH = 15  # ORBextractor.cc:73
PATCH_SIZE = 31
EDGE = 19  # EDGE_THRESHOLD, ORBextractor.cc:72 — also our pyramid pad width
DESC_PAD = 21  # max |rounded rotated BRIEF offset| (pattern radius ~17.7)

# FAST 16-pixel Bresenham circle, radius 3, circular order (dy, dx)
_FAST_RING = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


def compute_umax() -> np.ndarray:
    """Circular-patch row extents, exactly the reference ctor's algorithm
    (`src/ORBextractor.cc:452-468`)."""
    hp = HALF_PATCH
    umax = np.zeros(hp + 2, dtype=np.int64)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    hp2 = hp * hp
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    # ensure symmetry
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: hp + 1]


_UMAX = compute_umax()


def _circular_mask() -> np.ndarray:
    """(31,31) boolean mask of the IC_Angle patch from _UMAX."""
    mask = np.zeros((PATCH_SIZE, PATCH_SIZE), dtype=bool)
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        u_extent = _UMAX[abs(v)]
        mask[v + HALF_PATCH, HALF_PATCH - u_extent : HALF_PATCH + u_extent + 1] = True
    return mask


_IC_MASK = _circular_mask()


def _gaussian_kernel_7x7(sigma: float = 2.0) -> np.ndarray:
    """7x7 separable Gaussian (cv::GaussianBlur(7,7,2,2) parity:
    OpenCV's getGaussianKernel for ksize=7, sigma=2)."""
    r = np.arange(7) - 3
    k = np.exp(-(r**2) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


_BLUR_K = _gaussian_kernel_7x7()


def reflect101_pad(img: jax.Array, pad: int) -> jax.Array:
    """cv::BORDER_REFLECT_101 padding (edge pixel not duplicated)."""
    return jnp.pad(img, ((pad, pad), (pad, pad)), mode="reflect")


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    height: int
    width: int
    scale: float
    budget: int  # mnFeaturesPerLevel[level]
    cell: int  # selection cell size
    k_per_cell: int
    n_cells_y: int
    n_cells_x: int
    cand_cap: int  # = n_cells * k_per_cell


@dataclasses.dataclass(frozen=True)
class ORBSpec:
    """Static extraction plan for one image geometry."""

    height: int
    width: int
    n_features: int
    n_levels: int
    scale_factor: float
    ini_th: int
    min_th: int
    max_kp: int
    levels: tuple[LevelSpec, ...]

    @staticmethod
    def create(height: int, width: int, n_features: int = 2000,
               n_levels: int = 4, scale_factor: float = 1.5,
               ini_th: int = 15, min_th: int = 3, max_kp: int = 2048,
               cell: int = 16) -> "ORBSpec":
        # Per-level budgets: geometric split, remainder to the top level —
        # mirrors the reference ctor (`src/ORBextractor.cc:434-445`).
        factor = 1.0 / scale_factor
        n_desired = n_features * (1 - factor) / (1 - factor**n_levels)
        budgets = []
        total = 0
        for _ in range(n_levels - 1):
            b = int(round(n_desired))
            budgets.append(b)
            total += b
            n_desired *= factor
        budgets.append(max(n_features - total, 0))

        levels = []
        h, w = height, width
        for lvl in range(n_levels):
            scale = scale_factor**lvl
            if lvl > 0:
                h = int(round(height / scale))
                w = int(round(width / scale))
            ncy = max(1, h // cell)
            ncx = max(1, w // cell)
            n_cells = ncy * ncx
            # candidate pool >= 4x the budget share per cell: with a tight
            # pool (1.5x) the per-cell top-k competition churns ~15% of
            # selected keypoints per frame on corner-dense imagery, decaying
            # the tracked-point set (the reference's quadtree adapts node
            # size instead and keeps locally-dominant corners stably)
            k = max(6, math.ceil(4.0 * budgets[lvl] / n_cells))
            k = min(k, cell * cell)
            levels.append(
                LevelSpec(h, w, scale, budgets[lvl], cell, k, ncy, ncx, n_cells * k)
            )
        return ORBSpec(height, width, n_features, n_levels, scale_factor,
                       ini_th, min_th, max_kp, tuple(levels))


# Fixed-capacity keypoint set: plain dict of arrays (a registered pytree).
# Keys: xy (M,2) f32 level-0 pixel coords; response (M,) f32; angle_deg (M,)
# f32; octave (M,) i32; size (M,) f32; desc (M,32) u8; valid (M,) bool.
# Invalid slots have valid=False.
Keypoints = dict


def build_pyramid(spec: ORBSpec, image: jax.Array) -> list[jax.Array]:
    """List of EDGE-padded level images (Hl+2E, Wl+2E) float32.

    Mirrors `ComputePyramid` (`src/ORBextractor.cc:1110-1135`): level l is a
    bilinear resize of level l-1, stored inside a reflect-101 border.
    """
    levels = []
    cur = image.astype(jnp.float32)
    prev_h, prev_w = spec.height, spec.width
    for lvl, ls in enumerate(spec.levels):
        if lvl > 0:
            # Separable bilinear resize as two matmuls: linear resize
            # is a linear operator, so its per-axis matrices are exactly
            # `jax.image.resize` applied to identity — traced on constants,
            # they fold at compile time. The matmuls replace the
            # gather-based lowering of resize (~0.1 GFLOP).
            # Rounded to integers: the reference's cv::resize writes an 8U
            # level (`src/ORBextractor.cc:1124`), so every downstream
            # consumer (FAST, IC, BRIEF) sees integer pixels — and integer
            # values <= 255 are EXACT in bf16, which the hot kernels
            # exploit (see fast_score_map / brief_from_patches).
            R_h = jax.image.resize(jnp.eye(prev_h, dtype=jnp.float32),
                                   (ls.height, prev_h), method="linear")
            R_w = jax.image.resize(jnp.eye(prev_w, dtype=jnp.float32),
                                   (ls.width, prev_w), method="linear")
            cur = jnp.rint(R_h @ cur @ R_w.T)
        levels.append(reflect101_pad(cur, EDGE))
        prev_h, prev_w = ls.height, ls.width
    return levels


def fast_score_map(img: jax.Array, th_for_corner: int) -> jax.Array:
    """FAST-9/16 score for every pixel of `img` (H,W).

    Score = max threshold at which the segment test still passes (OpenCV's
    nonmax score); 0 where not a corner at `th_for_corner`. Border pixels
    (radius 3) score 0.
    """
    h, w = img.shape
    # 16 ring differences via shifted slices of a 3-padded image. The ring
    # min/max tree runs in bf16: pyramid pixels are integers <= 255
    # (build_pyramid rounds, reference-8U parity), so the differences are
    # integers in [-255,255] — EXACT in bf16 at half the HBM traffic of f32
    pad = jnp.pad(img, 3, mode="edge")
    ring = jnp.stack(
        [pad[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dy, dx in _FAST_RING]
    )  # (16,H,W)
    d = (ring - img[None]).astype(jnp.bfloat16)

    def arc9_min(x):
        # min over all 9-long circular windows, via doubling rolls on axis 0
        r2 = jnp.minimum(x, jnp.roll(x, -1, axis=0))
        r4 = jnp.minimum(r2, jnp.roll(r2, -2, axis=0))
        r8 = jnp.minimum(r4, jnp.roll(r4, -4, axis=0))
        r9 = jnp.minimum(r8, jnp.roll(x, -8, axis=0))
        return jnp.max(r9, axis=0)  # best starting position

    score_bright = arc9_min(d)  # > t means all 9 brighter by > t
    score_dark = arc9_min(-d)
    score = jnp.maximum(score_bright, score_dark).astype(jnp.float32)
    # continuous tie-breaker (< 1 integer unit): the FAST score on 8-bit
    # data is a small integer, so hundreds of corners tie at the per-level
    # budget cut and the retained subset churns ~20% per frame as raster
    # order shifts (kills tracked-point persistence). Mean |ring contrast|
    # is a smooth, frame-stable function of the image that orders ties
    # without ever crossing integer score levels.
    tie = jnp.sum(jnp.abs(d), axis=0, dtype=jnp.float32) * (0.99 / 4096.0)
    score = jnp.where(score > th_for_corner, score + tie, 0.0)
    # kill 3px border (matches detection starting at minBorder anyway)
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inb = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return jnp.where(inb, score, 0.0)


def _nms3(score: jax.Array) -> jax.Array:
    """3x3 non-max suppression; keeps strict maxima (ties broken toward
    earlier raster position, like OpenCV's row-scan)."""
    neigh = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where((score >= neigh) & (score > 0), score, 0.0)


def detect_level(spec: ORBSpec, ls: LevelSpec, padded: jax.Array):
    """FAST + dual-threshold cells + per-cell top-k on one level.

    Returns (xy (C,2) int32 level coords, score (C,) f32) with invalid
    entries scored 0. C = ls.cand_cap.
    """
    img = padded[EDGE : EDGE + ls.height, EDGE : EDGE + ls.width]
    score_min = fast_score_map(img, spec.min_th)
    score_min = _nms3(score_min)
    # detection border: minBorder = EDGE-3 (= 16), as src/ORBextractor.cc:770-775
    b = EDGE - 3
    ys = jnp.arange(ls.height)[:, None]
    xs = jnp.arange(ls.width)[None, :]
    inb = (ys >= b) & (ys < ls.height - b) & (xs >= b) & (xs < ls.width - b)
    score_min = jnp.where(inb, score_min, 0.0)

    # dual-threshold per cell: if a cell has any corner above ini_th keep
    # only those; else keep min_th corners (src/ORBextractor.cc:808-815)
    cy, cx, cell = ls.n_cells_y, ls.n_cells_x, ls.cell
    crop = score_min[: cy * cell, : cx * cell]
    cells = crop.reshape(cy, cell, cx, cell).transpose(0, 2, 1, 3)  # (cy,cx,cell,cell)
    cell_max = cells.max(axis=(2, 3))
    has_ini = cell_max > spec.ini_th
    keep = jnp.where(
        has_ini[:, :, None, None], cells > spec.ini_th, cells > 0.0
    )
    cells = jnp.where(keep, cells, 0.0)

    # per-cell top-k
    flat = cells.reshape(cy * cx, cell * cell)
    topv, topi = jax.lax.top_k(flat, ls.k_per_cell)  # (n_cells, k)
    cell_ids = jnp.arange(cy * cx)
    cell_y = (cell_ids // cx)[:, None] * cell
    cell_x = (cell_ids % cx)[:, None] * cell
    yy = cell_y + topi // cell
    xx = cell_x + topi % cell
    xy = jnp.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1).astype(jnp.int32)
    return xy, topv.reshape(-1)


def ic_moment_maps(padded: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(m10, m01) of the circular IC patch centered at EVERY pixel.

    Vectorized formulation of `IC_Angle` (`src/ORBextractor.cc:76-103`): a naive
    per-keypoint 31x31 patch gather costs C*961 random reads and a dense
    31x31 conv lowers terribly for 1-channel images; instead build row
    prefix sums once and reduce each circle row as a prefix-sum difference —
    31 shifted element-wise passes over the level:

        sum_{u=-m..m} I(y+v, x+u)       = S1(y+v, x+m) - S1(y+v, x-m-1)
        sum_{u=-m..m} u * I(y+v, x+u)   = [Sx diff] - x * [S1 diff]

    with m = umax(|v|) per circle row. Wrap-around from the rolls only
    contaminates a border strip well inside the EDGE padding (keypoints are
    >= minBorder from the level edge).
    """
    x_coords = jnp.arange(padded.shape[1], dtype=padded.dtype)
    S1 = jnp.cumsum(padded, axis=1)
    Sx = jnp.cumsum(padded * x_coords[None, :], axis=1)
    m10 = jnp.zeros_like(padded)
    m01 = jnp.zeros_like(padded)
    for dv in range(-HALF_PATCH, HALF_PATCH + 1):
        m = int(_UMAX[abs(dv)])
        S1d = jnp.roll(S1, -dv, axis=0)
        Sxd = jnp.roll(Sx, -dv, axis=0)
        sum1 = jnp.roll(S1d, -m, axis=1) - jnp.roll(S1d, m + 1, axis=1)
        sumx = jnp.roll(Sxd, -m, axis=1) - jnp.roll(Sxd, m + 1, axis=1)
        m10 = m10 + (sumx - x_coords[None, :] * sum1)
        m01 = m01 + dv * sum1
    return m10, m01


def ic_angles(padded: jax.Array, xy: jax.Array) -> jax.Array:
    """Intensity-centroid angles in degrees for level-coord keypoints (C,2).

    `IC_Angle` parity (`src/ORBextractor.cc:76-103`): moments over the
    radius-15 circular patch with _UMAX extents; angle = atan2(m01, m10),
    via whole-level moment maps (`ic_moment_maps`) + a 2-value read per
    keypoint."""
    m10_map, m01_map = ic_moment_maps(padded)
    yy = xy[:, 1] + EDGE
    xx = xy[:, 0] + EDGE
    m10 = m10_map[yy, xx]
    m01 = m01_map[yy, xx]
    ang = jnp.degrees(jnp.arctan2(m01, m10))
    return jnp.where(ang < 0, ang + 360.0, ang)


def gaussian_blur7(padded: jax.Array) -> jax.Array:
    """Separable 7x7 sigma-2 Gaussian (descriptor image, ORBextractor.cc:1089).

    Implemented as weighted shift-adds (element-wise f32 math) — a
    1-channel conv at HIGHEST precision is a poor fit for matrix units;
    the shifted adds are exact f32 FMAs.
    Shifts clamp at the array edge (the affected band lies inside the
    EDGE=19 padding, outside any descriptor sample).
    """
    k = _BLUR_K  # numpy (7,)
    h, w = padded.shape

    def pass1d(img, axis):
        out = k[3] * img
        for d in (1, 2, 3):
            lo = jnp.roll(img, d, axis=axis)
            hi = jnp.roll(img, -d, axis=axis)
            out = out + k[3 - d] * lo + k[3 + d] * hi
        return out

    return pass1d(pass1d(padded, 0), 1)


PATCH49 = 2 * (DESC_PAD + 3) + 1  # 49: BRIEF window (43) + blur margin (3)

# (31,31) circular-mask moment weights for the patch-form IC angle
_IC_DU = (np.arange(PATCH_SIZE) - HALF_PATCH)[None, :] * _IC_MASK
_IC_DV = (np.arange(PATCH_SIZE) - HALF_PATCH)[:, None] * _IC_MASK


def cut_patches_2ch(stack: jax.Array, xy: jax.Array) -> jax.Array:
    """(B,2,49,49) bf16 patches from an integer-valued (2,Hp,Wp) stack.

    A two-stage form instead of a vmapped `dynamic_slice`: a contiguous
    ROW gather followed by a per-keypoint column one-hot contraction. Exact because the
    stack holds integers <= 255 (bf16-representable)."""
    r = DESC_PAD + 3
    Wp = stack.shape[2]
    y0 = xy[:, 1] + (EDGE - r)
    x0 = xy[:, 0] + (EDGE - r)
    ys = y0[:, None] + jnp.arange(PATCH49)[None, :]  # (B,49)
    rows = stack[:, ys.reshape(-1), :]  # (2,B*49,Wp) contiguous row gather
    rows = rows.reshape(2, -1, PATCH49, Wp).transpose(1, 0, 2, 3)
    iota = jnp.arange(Wp, dtype=jnp.int32)
    ohc = (x0[:, None, None] + jnp.arange(PATCH49)[None, :, None]
           == iota[None, None, :])  # (B,49,Wp)
    return jnp.einsum("bcrw,bpw->bcrp", rows.astype(jnp.bfloat16),
                      ohc.astype(jnp.bfloat16),
                      preferred_element_type=jnp.bfloat16)


def cut_patches49(padded: jax.Array, xy: jax.Array) -> jax.Array:
    """One 49x49 patch per level-coord keypoint from the UNBLURRED padded
    level. 49 = BRIEF's 43x43 sampling window + the 3-pixel blur margin, so
    a single cut serves the IC angle, the in-patch Gaussian blur and the
    descriptor sampling — replacing three whole-image passes (moment maps,
    blur, per-keypoint re-cut) with per-keypoint work proportional to the
    BUDGET, not the image area."""
    r = DESC_PAD + 3
    starts = jnp.stack([xy[:, 1] + (EDGE - r),
                        xy[:, 0] + (EDGE - r)], -1).astype(jnp.int32)
    return jax.vmap(
        lambda s: jax.lax.dynamic_slice(padded, (s[0], s[1]),
                                        (PATCH49, PATCH49))
    )(starts)  # (B,49,49) f32


def ic_angles_from_patches(patches49: jax.Array) -> jax.Array:
    """IC angle from the (31,31) interior of the 49x49 patches.

    Same `IC_Angle` math (`src/ORBextractor.cc:76-103`) as `ic_angles`, as
    a mask-weighted reduction over the patch instead of whole-image prefix
    sums: m10 = sum(du*I), m01 = sum(dv*I) over the umax circle."""
    r = DESC_PAD + 3 - HALF_PATCH  # 9
    inner = patches49[:, r:r + PATCH_SIZE, r:r + PATCH_SIZE]
    m10 = jnp.sum(inner * jnp.asarray(_IC_DU, inner.dtype), axis=(1, 2))
    m01 = jnp.sum(inner * jnp.asarray(_IC_DV, inner.dtype), axis=(1, 2))
    ang = jnp.degrees(jnp.arctan2(m01, m10))
    return jnp.where(ang < 0, ang + 360.0, ang)


def blur7_patches(patches49: jax.Array) -> jax.Array:
    """7x7 sigma-2 Gaussian on each patch via shift-adds (see
    `gaussian_blur7`); rolls wrap, contaminating only the 3-pixel margin
    outside the 43x43 interior that BRIEF samples."""
    k = _BLUR_K

    def pass1d(img, axis):
        out = k[3] * img
        for d in (1, 2, 3):
            out = out + k[3 - d] * jnp.roll(img, d, axis=axis) \
                + k[3 + d] * jnp.roll(img, -d, axis=axis)
        return out

    return pass1d(pass1d(patches49, 1), 2)


def brief_from_patches(patches43: jax.Array, angles_deg: jax.Array
                       ) -> jax.Array:
    """Rotated BRIEF-256 from pre-cut blurred 43x43 patches, (C,32) u8.

    Sampling parity with `computeOrbDescriptor` (`src/ORBextractor.cc:
    107-146`) INCLUDING the 8-bit blur image: the reference samples a
    GaussianBlur written to 8U (`src/ORBextractor.cc:1089`), so sample
    values are integers 0..255 — exactly representable in bf16. Rounding
    the patches here therefore (a) matches the reference's quantization
    and (b) lets the one-hot row-select run as a SINGLE bf16 einsum with
    bf16 accumulation (each output picks exactly one element — no summed
    rounding), at half the traffic of the old f32 hi/lo split."""
    c = patches43.shape[0]
    W = 2 * DESC_PAD + 1  # 43
    a = jnp.cos(jnp.radians(angles_deg))
    b = jnp.sin(jnp.radians(angles_deg))
    pat = jnp.asarray(BIT_PATTERN_31, dtype=jnp.float32)  # (256,4)
    px = jnp.concatenate([pat[:, 0], pat[:, 2]])  # (512,)
    py = jnp.concatenate([pat[:, 1], pat[:, 3]])
    col_off = jnp.round(
        px[None, :] * a[:, None] - py[None, :] * b[:, None]).astype(jnp.int32)
    row_off = jnp.round(
        px[None, :] * b[:, None] + py[None, :] * a[:, None]).astype(jnp.int32)
    iota = jnp.arange(W, dtype=jnp.int32)
    oh_r = (row_off[..., None] + DESC_PAD == iota)  # (C,512,43) bool
    oh_c = (col_off[..., None] + DESC_PAD == iota)
    p_int = jnp.rint(patches43).astype(jnp.bfloat16)  # integers <=255: exact
    rows = jnp.einsum("crj,csr->csj", p_int, oh_r.astype(jnp.bfloat16),
                      preferred_element_type=jnp.bfloat16)
    vals = jnp.sum(jnp.where(oh_c, rows, jnp.bfloat16(0)), -1)  # (C,512)
    t0, t1 = vals[:, :256], vals[:, 256:]
    bits = (t0 < t1).astype(jnp.uint8)  # (C,256)
    weights = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], dtype=jnp.uint8)
    return jnp.einsum(
        "ckb,b->ck", bits.reshape(c, 32, 8).astype(jnp.uint32),
        weights.astype(jnp.uint32),
    ).astype(jnp.uint8)


def brief_descriptors(blurred: jax.Array, xy: jax.Array, angles_deg: jax.Array
                      ) -> jax.Array:
    """Rotated BRIEF-256 descriptors, (C,32) uint8.

    `computeOrbDescriptor` parity (`src/ORBextractor.cc:107-146`): for each
    pattern point (px,py), sample at (row=round(px*sin+py*cos),
    col=round(px*cos-py*sin)) relative to the keypoint; bit = I(p0) < I(p1);
    bits packed LSB-first into 32 bytes.

    Instead of C*512 random reads: (a) cut a 43x43 patch per keypoint
    with vmapped dynamic_slice (contiguous rows), then (b) select the 512
    rotated samples with two one-hot contractions. The row-select matmul
    runs in bf16 with an hi/lo split (vals = hi @ oh + lo @ oh, f32
    accumulation), which reconstructs the f32 sample to ~2^-16 relative —
    far below any t0<t1 comparison except exact ties — and exactly for
    samples with at most 16 significant bits.
    """
    c = xy.shape[0]
    W = 2 * DESC_PAD + 1  # 43
    a = jnp.cos(jnp.radians(angles_deg))  # (C,)
    b = jnp.sin(jnp.radians(angles_deg))
    pat = jnp.asarray(BIT_PATTERN_31, dtype=jnp.float32)  # (256,4)
    px = jnp.concatenate([pat[:, 0], pat[:, 2]])  # (512,)
    py = jnp.concatenate([pat[:, 1], pat[:, 3]])
    # rotated integer offsets per keypoint per sample: (C,512) in [-21,21]
    col_off = jnp.round(
        px[None, :] * a[:, None] - py[None, :] * b[:, None]).astype(jnp.int32)
    row_off = jnp.round(
        px[None, :] * b[:, None] + py[None, :] * a[:, None]).astype(jnp.int32)
    # per-keypoint patch (dynamic_slice clamps out-of-range starts; all
    # real keypoints sit >= minBorder so their patches stay inside EDGE)
    starts = jnp.stack([xy[:, 1] + (EDGE - DESC_PAD),
                        xy[:, 0] + (EDGE - DESC_PAD)], -1).astype(jnp.int32)
    patches = jax.vmap(
        lambda s: jax.lax.dynamic_slice(blurred, (s[0], s[1]), (W, W))
    )(starts)  # (C,43,43) f32
    iota = jnp.arange(W, dtype=jnp.int32)
    oh_r = (row_off[..., None] + DESC_PAD == iota)  # (C,512,43) bool
    oh_c = (col_off[..., None] + DESC_PAD == iota)
    # hi = the top 16 bits of each f32 (exactly a bf16), cut with integer
    # ops: a float round trip f32 -> bf16 -> f32 is an identity that XLA
    # may fold away where it allows excess precision (the GPU does), which
    # would leave lo = 0 and the split inexact
    hi = jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(patches, jnp.uint32)
        & jnp.uint32(0xFFFF0000), jnp.float32)
    p_hi = hi.astype(jnp.bfloat16)
    p_lo = (patches - hi).astype(jnp.bfloat16)
    ohr_b = oh_r.astype(jnp.bfloat16)
    rows = jnp.einsum("crj,csr->csj", p_hi, ohr_b,
                      preferred_element_type=jnp.float32)
    rows = rows + jnp.einsum("crj,csr->csj", p_lo, ohr_b,
                             preferred_element_type=jnp.float32)
    # column select: elementwise mask + reduce (exact f32 math)
    vals = jnp.sum(jnp.where(oh_c, rows, 0.0), -1)  # (C,512)
    t0, t1 = vals[:, :256], vals[:, 256:]
    bits = (t0 < t1).astype(jnp.uint8)  # (C,256)
    weights = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], dtype=jnp.uint8)
    return jnp.einsum(
        "ckb,b->ck", bits.reshape(c, 32, 8).astype(jnp.uint32),
        weights.astype(jnp.uint32),
    ).astype(jnp.uint8)


def extract(spec: ORBSpec, image: jax.Array, mask: jax.Array | None = None
            ) -> Keypoints:
    """Full ORB extraction on one grayscale image (H,W) float32 [0,255].

    `mask` (H,W): zero/False pixels are excluded — the fork's human-mask
    hook (`src/ORBextractor.cc:1048-1053`, `src/Tracking.cc:373-384`). The
    reference multiplies the INPUT image by the mask; we instead suppress
    detections whose center falls in the masked region (same intent without
    fabricating gradient corners at the mask boundary).
    """
    if image.shape != (spec.height, spec.width):
        raise ValueError(
            f"image shape {image.shape} != ORBSpec ({spec.height}, {spec.width})"
            " — Camera.width/height in the settings yaml must match the input"
        )
    pyramid = build_pyramid(spec, image)
    all_xy, all_resp, all_ang, all_oct, all_desc = [], [], [], [], []
    for lvl, ls in enumerate(spec.levels):
        padded = pyramid[lvl]
        xy, score = detect_level(spec, ls, padded)
        if mask is not None:
            m = jax.image.resize(
                mask.astype(jnp.float32), (ls.height, ls.width), method="nearest"
            )
            score = jnp.where(m[xy[:, 1], xy[:, 0]] > 0, score, 0.0)
        # keep level budget by response (continuous tie-broken score —
        # round-robin-over-cells was tried and measured WORSE: weak
        # min-th-only cells promote flickery corners over strong cells'
        # runners-up)
        score_sel, sel = jax.lax.top_k(score, min(ls.budget, score.shape[0]))
        xy = xy[sel]
        # ONE 2-channel patch cut per BUDGETED keypoint feeds both the IC
        # angle (unblurred channel) and BRIEF (blurred channel) — the old
        # path computed whole-image moment maps for every PIXEL and cut a
        # second patch set inside brief_descriptors. The
        # blur is rounded to integers first (reference stores its blur as
        # 8U, `src/ORBextractor.cc:1089`), making every patch value an
        # integer <= 255 — exact in bf16, so the cut runs fully in bf16.
        blurred = jnp.rint(gaussian_blur7(padded))
        stack = jnp.stack([padded, blurred])  # (2,Hp,Wp) integer-valued
        pp = cut_patches_2ch(stack, xy)  # (B,2,49,49) bf16
        ang = ic_angles_from_patches(pp[:, 0].astype(jnp.float32))
        W43 = 2 * DESC_PAD + 1
        desc = brief_from_patches(pp[:, 1, 3:3 + W43, 3:3 + W43], ang)
        all_xy.append(xy.astype(jnp.float32) * ls.scale)
        all_resp.append(jnp.where(score_sel > 0, score_sel, -jnp.inf))
        all_ang.append(ang)
        all_oct.append(jnp.full(xy.shape[0], lvl, dtype=jnp.int32))
        all_desc.append(desc)

    xy = jnp.concatenate(all_xy)
    resp = jnp.concatenate(all_resp)
    ang = jnp.concatenate(all_ang)
    octv = jnp.concatenate(all_oct)
    desc = jnp.concatenate(all_desc)
    m = xy.shape[0]
    cap = spec.max_kp
    if m < cap:
        pad = cap - m
        xy = jnp.concatenate([xy, jnp.zeros((pad, 2), xy.dtype)])
        resp = jnp.concatenate([resp, jnp.full((pad,), -jnp.inf)])
        ang = jnp.concatenate([ang, jnp.zeros((pad,), ang.dtype)])
        octv = jnp.concatenate([octv, jnp.zeros((pad,), octv.dtype)])
        desc = jnp.concatenate([desc, jnp.zeros((pad, 32), desc.dtype)])
    elif m > cap:
        resp_top, sel = jax.lax.top_k(resp, cap)
        xy, resp, ang, octv, desc = xy[sel], resp_top, ang[sel], octv[sel], desc[sel]
    valid = jnp.isfinite(resp)
    size = PATCH_SIZE * (spec.scale_factor ** octv.astype(jnp.float32))
    return Keypoints(
        xy=xy, response=jnp.where(valid, resp, 0.0), angle_deg=ang,
        octave=octv, size=size, desc=desc, valid=valid,
    )


def make_extractor(spec: ORBSpec):
    """jit-compiled extraction closure for a fixed image geometry."""

    @jax.jit
    def run(image, mask=None):
        return extract(spec, image, mask)

    return run
