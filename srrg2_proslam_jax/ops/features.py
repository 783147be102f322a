"""Dense feature frontend: FAST-9/16 + BRIEF-256 over whole images.

Capability parity with the reference's OpenCV-based extractors
(IntensityFeatureExtractorBinned_, reference srrg2_proslam/src/srrg2_proslam/
sensor_processing/feature_extractors/intensity_feature_extractor_binned.cpp:47-201:
FAST detection, non-maximum suppression, a detector grid with per-region
top-K by response, and 256-bit binary descriptors) — redesigned as dense
vectorized array ops:

  * FAST-9/16 corner test and score are computed jointly for every pixel:
    score = max over the 16 contiguous 9-arcs of the arc-min absolute
    center difference (exactly the maximum threshold at which the pixel
    remains a corner — the standard FAST score), via 16 shifted copies of
    the image.  Pure elementwise work, no scalar loops.
  * 3x3 non-maximum suppression via max-pooling.
  * The reference's R x C detector grid becomes a static per-region
    ``top_k`` quota, yielding a fixed-capacity keypoint set with a validity
    mask (SURVEY.md §7.1: masks, not resizes).
  * Descriptors are upright BRIEF-256 on a box-smoothed image (random pair
    pattern frozen at module import).  The reference defaults to ORB-256
    (kitti.conf "descriptor_type": "ORB-256"); upright BRIEF matches its
    matching behavior for the roll-free stereo/RGB-D trajectories the
    reference targets, and thresholds are retuned rather than bit-matched
    (SURVEY.md §7.3 hard part 3).

The "selective" tracking-mode extractor of the reference (detection masks
seeded by map projections, intensity_feature_extractor_selective.cpp) is a
CPU work-saving device; here detection is always dense and the projective
matcher does the seeding — same capability, accelerator-shaped.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..utils import config as cfg

# FAST Bresenham circle of radius 3, 16 offsets in clockwise order (dy, dx).
_FAST_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

_ARC_LENGTH = 9  # FAST-9

# BRIEF-256 sampling pattern: pairs drawn from N(0, (patch/5)^2), clipped to
# the 31x31 patch, frozen with a fixed seed for reproducibility.
_PATCH_RADIUS = 15
_rng = np.random.RandomState(0xB51EF)
_BRIEF_PAIRS = np.clip(
    np.round(_rng.normal(0.0, _PATCH_RADIUS / 2.2, size=(256, 2, 2))),
    -_PATCH_RADIUS,
    _PATCH_RADIUS,
).astype(np.int32)  # [256, {p,q}, {dy,dx}]

BORDER = _PATCH_RADIUS + 3  # keypoints must keep both FAST circle and BRIEF patch inside


@cfg.register
class FeatureExtractorConfig:
    """Mirrors IntensityFeatureExtractorBinned3D params (kitti.conf:779-810)."""

    detector_threshold: float = 15.0
    grid_rows: int = 3                 # number_of_detectors_vertical
    grid_cols: int = 3                 # number_of_detectors_horizontal
    max_keypoints: int = 1152          # target_number_of_keypoints (padded capacity)
    enable_nms: bool = True
    nms_window: int = 3
    smoothing_window: int = 5          # BRIEF pre-blur box size
    # rotation-aware descriptors: intensity-centroid orientation + rotated
    # BRIEF sampling (ORB-256 equivalent, the reference's default
    # descriptor_type, kitti.conf "descriptor_type": "ORB-256").  Off by
    # default: the planar KITTI/ICL trajectories carry no roll and the
    # upright path matches the retuned thresholds; EuRoC's MAV does roll.
    oriented: bool = False


class Features(NamedTuple):
    """Fixed-capacity keypoint set for one image."""

    uv: jnp.ndarray        # [N, 2] float32 (u=col, v=row), sub-pixel not refined
    response: jnp.ndarray  # [N] float32 FAST score
    desc: jnp.ndarray      # [N, 256] int8 in {-1, +1} (signed BRIEF bits)
    valid: jnp.ndarray     # [N] bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[-2]


def fast_scores(image: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Per-pixel FAST-9/16 corner score (0 where not a corner).

    image: [..., H, W] float32.  Returns [..., H, W] float32 scores
    (leading batch dimensions pass through).  The 16 ring samples stay
    separate arrays (no stacked [16, ..., H, W] operand), so XLA fuses the
    whole stencil into one elementwise pass over the image.
    """
    # ring[k][y, x] = image[y + dy_k, x + dx_k]
    ring = [jnp.roll(image, (-int(dy), -int(dx)), axis=(-2, -1))
            for dy, dx in _FAST_OFFSETS]

    def arc_score(diff):
        # max over 16 circular windows of the window-min — the exact FAST
        # score (largest t such that some 9-arc is uniformly beyond t).
        # Two-level min tree: min9(r) = min(min3(r), min3(r+3), min3(r+6))
        # — 3.2x fewer elementwise mins than 16 independent 9-wide windows
        # (identical result; min is associative).
        d2 = diff + diff[: _ARC_LENGTH - 1]                 # 24 entries
        m3 = [jnp.minimum(jnp.minimum(d2[i], d2[i + 1]), d2[i + 2])
              for i in range(22)]
        mins = [jnp.minimum(jnp.minimum(m3[r], m3[r + 3]), m3[r + 6])
                for r in range(16)]
        while len(mins) > 1:
            mins = [jnp.maximum(a, b) for a, b in zip(mins[::2], mins[1::2])]
        return mins[0]

    score = jnp.maximum(arc_score([s - image for s in ring]),
                        arc_score([image - s for s in ring]))
    return jnp.where(score > threshold, score, 0.0)


def _maxpool2d(x: jnp.ndarray, window: int) -> jnp.ndarray:
    """Max pool over the last two dims; leading batch dims pass through."""
    ones = (1,) * (x.ndim - 2)
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, ones + (window, window),
        (1,) * x.ndim, "SAME"
    )


def _boxfilter(x: jnp.ndarray, window: int) -> jnp.ndarray:
    # separable: two 1-D passes (2w adds/pixel instead of w^2);
    # batch-rank-agnostic like _maxpool2d
    ones = (1,) * (x.ndim - 2)
    strides = (1,) * x.ndim
    s = jax.lax.reduce_window(
        x, 0.0, jax.lax.add, ones + (window, 1), strides, "SAME"
    )
    s = jax.lax.reduce_window(
        s, 0.0, jax.lax.add, ones + (1, window), strides, "SAME"
    )
    return s / float(window * window)


def detect_keypoints_batch(images: jnp.ndarray,
                           config: FeatureExtractorConfig,
                           mask: jnp.ndarray = None):
    """Natively batched FAST detection with NMS and per-grid-region quotas.

    images: [B, H, W] float32.  Returns (uv [B,N,2], response [B,N],
    valid [B,N]) with N = config.max_keypoints (rounded down to a multiple
    of grid cells).  The whole batch runs through ONE 2-D ``top_k``
    ([B*regions, region_pixels]), the operand form XLA's TopK
    implementations take directly; a vmapped or 3-D ``top_k`` is lowered
    through a full sort instead — callers must NOT wrap this in jax.vmap.

    ``mask`` ([B, H, W] or [H, W] bool, optional) restricts detection to
    True pixels — the seeded/selective detection mode of the reference
    (intensity_feature_extractor_selective.cpp:49-205).
    """
    B, H, W = images.shape
    score_raw = fast_scores(images, config.detector_threshold)
    score = score_raw
    if mask is not None:
        score = jnp.where(jnp.broadcast_to(mask, score.shape), score, 0.0)
    if config.enable_nms:
        pooled = _maxpool2d(score, config.nms_window)
        score = jnp.where(score >= pooled, score, 0.0)
    # mask image border
    row = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    in_border = (row >= BORDER) & (row < H - BORDER) & (col >= BORDER) & (col < W - BORDER)
    score = jnp.where(in_border[None], score, 0.0)

    gr, gc = config.grid_rows, config.grid_cols
    n_regions = gr * gc
    k_region = config.max_keypoints // n_regions
    # pad to multiples of the grid
    Hp = -(-H // gr) * gr
    Wp = -(-W // gc) * gc
    score_p = jnp.pad(score, ((0, 0), (0, Hp - H), (0, Wp - W)))
    rh, cw = Hp // gr, Wp // gc
    # [B, gr, rh, gc, cw] -> [B*n_regions, rh*cw] (2-D for the fast TopK)
    regions = score_p.reshape(B, gr, rh, gc, cw) \
                     .transpose(0, 1, 3, 2, 4) \
                     .reshape(B * n_regions, rh * cw)
    top_scores, top_idx = jax.lax.top_k(regions, k_region)
    top_scores = top_scores.reshape(B, n_regions, k_region)
    top_idx = top_idx.reshape(B, n_regions, k_region)
    # flat region index -> global (row, col)
    rr = top_idx // cw
    cc = top_idx % cw
    region_r = jax.lax.broadcasted_iota(
        jnp.int32, (B, n_regions, k_region), 1) // gc
    region_c = jax.lax.broadcasted_iota(
        jnp.int32, (B, n_regions, k_region), 1) % gc
    rows = (region_r * rh + rr).reshape(B, -1)
    cols = (region_c * cw + cc).reshape(B, -1)
    response = top_scores.reshape(B, -1)
    valid = response > 0.0
    # Sub-pixel refinement: 1-D parabola fits on the raw (pre-NMS) FAST
    # score surface.  Without this, integer keypoints quantize stereo
    # disparity to whole pixels and far points report zero depth change
    # between frames, biasing forward translation low by ~20% on KITTI.
    rc = jnp.clip(rows, 1, H - 2)
    cc = jnp.clip(cols, 1, W - 2)
    flat = score_raw.reshape(B, H * W)
    lin = rc * W + cc

    def at(off):
        return jnp.take_along_axis(flat, lin + off, axis=1)

    s0 = at(0)
    sl = at(-1)
    sr = at(1)
    su = at(-W)
    sd = at(W)

    def parabola(minus, center, plus):
        denom = minus - 2.0 * center + plus
        off = 0.5 * (minus - plus) / jnp.where(jnp.abs(denom) < 1e-6, 1e-6, denom)
        return jnp.clip(off, -0.5, 0.5)

    du = parabola(sl, s0, sr)
    dv = parabola(su, s0, sd)
    uv = jnp.stack(
        [cols.astype(jnp.float32) + du, rows.astype(jnp.float32) + dv], axis=-1
    )
    # pad up to max_keypoints capacity
    pad = config.max_keypoints - uv.shape[1]
    if pad > 0:
        uv = jnp.pad(uv, ((0, 0), (0, pad), (0, 0)))
        response = jnp.pad(response, ((0, 0), (0, pad)))
        valid = jnp.pad(valid, ((0, 0), (0, pad)))
    return uv, response, valid


def detect_keypoints(image: jnp.ndarray, config: FeatureExtractorConfig,
                     mask: jnp.ndarray = None):
    """Single-image wrapper of :func:`detect_keypoints_batch`.

    image: [H, W] float32.  Returns (uv [N,2], response [N], valid [N]).
    """
    if mask is not None:
        mask = mask[None]
    uv, response, valid = detect_keypoints_batch(image[None], config, mask)
    return uv[0], response[0], valid[0]


def _centroid_angles(image: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel intensity-centroid orientation map (ORB, Rosin moments).

    theta[y, x] = atan2(m01, m10) of the radius-_PATCH_RADIUS disc centered
    at (y, x).  Computed as two dense 31x31 convolutions (x*disc and y*disc
    kernels) — one pass for every keypoint at once, instead of
    the reference's per-keypoint scalar moment loops inside OpenCV ORB.
    """
    r = _PATCH_RADIUS
    d = np.arange(-r, r + 1, dtype=np.float32)
    yy, xx = np.meshgrid(d, d, indexing="ij")
    disc = (yy * yy + xx * xx <= r * r).astype(np.float32)
    kx = jnp.asarray(xx * disc)  # [31, 31]
    ky = jnp.asarray(yy * disc)
    img4 = image[None, None]  # NCHW
    kern = jnp.stack([kx, ky])[:, None]  # [2, 1, 31, 31]
    m = jax.lax.conv_general_dilated(
        img4, kern, window_strides=(1, 1), padding="SAME"
    )[0]  # [2, H, W]
    return jnp.arctan2(m[1], m[0])


def compute_descriptors(image: jnp.ndarray, uv: jnp.ndarray, valid: jnp.ndarray,
                        config: FeatureExtractorConfig) -> jnp.ndarray:
    """BRIEF-256 at integer keypoint locations (upright or rotation-aware).

    With ``config.oriented`` the sampling pattern is rotated per keypoint by
    the intensity-centroid angle and read with bilinear interpolation —
    ORB-256 equivalence (the reference's default descriptor).  Returns
    signed descriptors [N, 256] int8 in {-1, +1}; invalid keypoints get all
    -1 (harmless: callers mask by validity).
    """
    H, W = image.shape
    smooth = _boxfilter(image, config.smoothing_window)
    y = jnp.clip(uv[:, 1].astype(jnp.int32), BORDER, H - BORDER - 1)
    x = jnp.clip(uv[:, 0].astype(jnp.int32), BORDER, W - BORDER - 1)
    p_off = jnp.asarray(_BRIEF_PAIRS[:, 0])  # [256, 2] (dy, dx)
    q_off = jnp.asarray(_BRIEF_PAIRS[:, 1])
    if config.oriented:
        theta = _centroid_angles(smooth)[y, x]  # [N]
        c, s = jnp.cos(theta)[:, None], jnp.sin(theta)[:, None]

        def rotated_sample(off):
            dy = off[None, :, 0].astype(jnp.float32)
            dx = off[None, :, 1].astype(jnp.float32)
            ry = y[:, None] + dx * s + dy * c  # [N, 256] float
            rx = x[:, None] + dx * c - dy * s
            ry = jnp.clip(ry, 0.0, H - 1.001)
            rx = jnp.clip(rx, 0.0, W - 1.001)
            y0 = ry.astype(jnp.int32)
            x0 = rx.astype(jnp.int32)
            fy = ry - y0
            fx = rx - x0
            v00 = smooth[y0, x0]
            v01 = smooth[y0, x0 + 1]
            v10 = smooth[y0 + 1, x0]
            v11 = smooth[y0 + 1, x0 + 1]
            return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
                    + fy * ((1 - fx) * v10 + fx * v11))

        a = rotated_sample(p_off)
        b = rotated_sample(q_off)
    else:
        py = y[:, None] + p_off[None, :, 0]
        px = x[:, None] + p_off[None, :, 1]
        qy = y[:, None] + q_off[None, :, 0]
        qx = x[:, None] + q_off[None, :, 1]
        a = smooth[py, px]  # [N, 256] gathers
        b = smooth[qy, qx]
    bits = a < b
    signed = jnp.where(bits, jnp.int8(1), jnp.int8(-1))
    return jnp.where(valid[:, None], signed, jnp.int8(-1))


def extract_features(image: jnp.ndarray, config: FeatureExtractorConfig,
                     mask: jnp.ndarray = None) -> Features:
    """Full frontend for one grayscale image [H, W] float32 (0..255)."""
    uv, response, valid = detect_keypoints(image, config, mask)
    desc = compute_descriptors(image, uv, valid, config)
    return Features(uv=uv, response=response, desc=desc, valid=valid)


def extract_features_batch(images: jnp.ndarray,
                           config: FeatureExtractorConfig) -> Features:
    """Batched frontend for [B, H, W] images -> Features with leading B.

    Detection runs natively batched (one 2-D ``top_k`` for the whole
    batch, see :func:`detect_keypoints_batch`); descriptors are the
    per-keypoint gathers of :func:`compute_descriptors`, vmapped.
    """
    uv, response, valid = detect_keypoints_batch(images, config)
    desc = jax.vmap(
        lambda im, u, v: compute_descriptors(im, u, v, config)
    )(images, uv, valid)
    return Features(uv=uv, response=response, desc=desc, valid=valid)


def stripe_mask(rows: int, cols: int, seed_v: jnp.ndarray,
                seed_valid: jnp.ndarray, thickness: float = 2.0):
    """Epipolar stripe mask from seed keypoint rows (selective mode S3).

    True on every image row within ``thickness`` px of some valid seed
    keypoint's v coordinate — the reference's full-row stripe mode for
    seeded right-camera stereo detection
    (intensity_feature_extractor_selective.cpp:80-125).
    """
    v = jax.lax.broadcasted_iota(jnp.float32, (rows, 1), 0)
    dist = jnp.abs(v - jnp.where(seed_valid, seed_v, -1e9)[None, :])
    hit = jnp.min(dist, axis=1, keepdims=True) <= thickness
    return jnp.broadcast_to(hit, (rows, cols))
