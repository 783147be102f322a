"""Descriptor matching kernels: brute-force, epipolar stereo, projective.

Capability parity with the reference's seven correspondence-finder families
(SURVEY.md §2 R1-R6):

  * R1 brute-force with bijectivity + two-sided Lowe ratio
    (correspondence_finder_descriptor_based_bruteforce_impl.cpp:88-152) —
    here: one masked Hamming matrix + mutual-argmin + row/col Lowe checks.
  * R2 epipolar stereo sweep with disparity bound and row widening
    (correspondence_finder_descriptor_based_epipolar_impl.cpp:72-206) —
    here: the same matrix with an epipolar feasibility mask
    (|dv| <= thickness, 0 <= disparity <= max), one pass, no sweeps.
  * R3-R6 projective tracking matchers with square/circle/rhombus search
    lattices and adaptive radius/threshold recursion
    (correspondence_finder_projective_base_impl.cpp:227-288) — here: a
    geometric-distance mask under the L-inf/L2/L1 norm (the three search
    patterns collapse to a norm choice) and a *staged* radius/threshold
    schedule evaluated from the same cost matrix in one shot: counts for
    every stage are cheap reductions, and the tightest stage reaching the
    target matching ratio is selected with a vectorized argmax — replacing
    the reference's data-dependent recursion (SURVEY.md §7.3 hard part 1).

Everything is fixed-shape: matchers return per-row target indices with a
validity mask, never compacted lists.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..utils import config as cfg
from .hamming import distance_matrix

# NB: a Python scalar, NOT jnp.float32(1e9) — a module-level device array
# becomes a committed captured constant in every jit that uses it, passed
# to each execution as an extra argument; the scalar literal folds into
# the program.
_BIG = 1e9


@cfg.register
class BruteforceMatcherConfig:
    """Mirrors CorrespondenceFinderDescriptorBasedBruteforce (kitti.conf:79-88)."""

    maximum_descriptor_distance: float = 50.0
    lowe_ratio: float = 0.5            # maximum_distance_ratio_to_second_best
    minimum_matching_ratio: float = 0.25


@cfg.register
class EpipolarMatcherConfig:
    """Mirrors CorrespondenceFinderDescriptorBasedEpipolar (kitti.conf:484-501)."""

    epipolar_thickness_px: float = 1.0
    maximum_descriptor_distance: float = 100.0
    maximum_disparity_px: float = 100.0
    minimum_disparity_px: float = 0.0
    lowe_ratio: float = 0.5
    minimum_matching_ratio: float = 0.3


@cfg.register
class ProjectiveMatcherConfig:
    """Mirrors CorrespondenceFinderProjectiveCircle4D3D (kitti.conf:833-877).

    The staged schedules replace the reference's adaptive radius/threshold
    state machine: stage i uses (radius_stages[i], descriptor_stages[i]);
    the tightest stage whose matching ratio reaches
    ``minimum_matching_ratio`` wins.

    The pairing follows the reference's widen-on-loss dynamics
    (correspondence_finder_projective_base_impl.cpp:227-263): a WIDE search
    radius pairs with a STRICT descriptor threshold (appearance must be
    decisive when geometry is uninformative), a tight radius with a loose
    one.  Pairing both ascending floods wide windows with aliased texture
    matches — measured 15% match precision vs 99% flipped on the rendered
    turn-onset frames — and breaks tracking through turns.
    """

    radius_stages: tuple = (10.0, 25.0, 90.0)       # min..max search radius px
    descriptor_stages: tuple = (75.0, 50.0, 25.0)   # paired LOOSE..STRICT
    lowe_ratio: float = 0.8
    minimum_matching_ratio: float = 0.1
    norm: str = "circle"  # "circle" (L2) | "square" (Linf) | "rhombus" (L1)


class Matches(NamedTuple):
    """Row-aligned match set: for each element of set A, a target in set B."""

    idx: jnp.ndarray       # [N_a] int32 index into B, -1 if unmatched
    distance: jnp.ndarray  # [N_a] float32 descriptor distance (BIG if unmatched)
    mask: jnp.ndarray      # [N_a] bool

    @property
    def count(self) -> jnp.ndarray:
        return jnp.sum(self.mask)


def _min2(masked_cost: jnp.ndarray):
    """Row-wise (best, second-best, argmin) of a [N, M] masked cost matrix."""
    best_idx = jnp.argmin(masked_cost, axis=1)
    d1 = jnp.min(masked_cost, axis=1)
    cols = jnp.arange(masked_cost.shape[1])[None, :]
    without_best = jnp.where(cols == best_idx[:, None], _BIG, masked_cost)
    d2 = jnp.min(without_best, axis=1)
    return d1, d2, best_idx


def match_cost_matrix(
    cost: jnp.ndarray,
    feasible: jnp.ndarray,
    max_distance: float,
    lowe_ratio: float,
) -> Matches:
    """Shared matcher core: bijective mutual-best with Lowe ratio.

    cost: [N_a, N_b] float32, feasible: [N_a, N_b] bool (includes validity).
    A row match survives iff it is the mutual argmin of its row and column,
    beats ``max_distance``, and passes the row-wise Lowe ratio test
    (reference does the two-sided test through its sorted candidate pools;
    mutual-best subsumes the column side here).
    """
    masked = jnp.where(feasible, cost, _BIG)
    d1, d2, best_b = _min2(masked)
    col_best_a = jnp.argmin(masked, axis=0)  # [N_b]
    mutual = col_best_a[best_b] == jnp.arange(cost.shape[0])
    lowe_ok = d1 <= lowe_ratio * d2
    ok = (d1 <= max_distance) & lowe_ok & mutual
    return Matches(
        idx=jnp.where(ok, best_b, -1).astype(jnp.int32),
        distance=jnp.where(ok, d1, _BIG),
        mask=ok,
    )


def match_bruteforce(
    desc_a: jnp.ndarray,
    valid_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_b: jnp.ndarray,
    config: BruteforceMatcherConfig,
) -> Matches:
    """Exhaustive descriptor matching (reference R1)."""
    cost = distance_matrix(desc_a, desc_b).astype(jnp.float32)
    feasible = valid_a[:, None] & valid_b[None, :]
    return match_cost_matrix(
        cost, feasible, config.maximum_descriptor_distance, config.lowe_ratio
    )


def match_epipolar(
    uv_left: jnp.ndarray,
    desc_left: jnp.ndarray,
    valid_left: jnp.ndarray,
    uv_right: jnp.ndarray,
    desc_right: jnp.ndarray,
    valid_right: jnp.ndarray,
    config: EpipolarMatcherConfig,
) -> Matches:
    """Rectified stereo matching along epipolar lines (reference R2).

    Row alignment |v_L - v_R| <= thickness and disparity in
    [minimum, maximum] gate the Hamming matrix; the reference's widening
    row-offset passes are subsumed by the thickness window.
    """
    cost = distance_matrix(desc_left, desc_right).astype(jnp.float32)
    dv = jnp.abs(uv_left[:, None, 1] - uv_right[None, :, 1])
    disparity = uv_left[:, None, 0] - uv_right[None, :, 0]
    feasible = (
        valid_left[:, None]
        & valid_right[None, :]
        & (dv <= config.epipolar_thickness_px)
        & (disparity >= config.minimum_disparity_px)
        & (disparity <= config.maximum_disparity_px)
    )
    return match_cost_matrix(
        cost, feasible, config.maximum_descriptor_distance, config.lowe_ratio
    )


def _geometric_distance(delta: jnp.ndarray, norm: str) -> jnp.ndarray:
    if norm == "square":
        return jnp.max(jnp.abs(delta), axis=-1)
    if norm == "rhombus":
        return jnp.sum(jnp.abs(delta), axis=-1)
    return jnp.sqrt(jnp.sum(delta * delta, axis=-1) + 1e-12)


def match_projective(
    meas_uv: jnp.ndarray,
    meas_desc: jnp.ndarray,
    meas_valid: jnp.ndarray,
    proj_uv: jnp.ndarray,
    proj_desc: jnp.ndarray,
    proj_valid: jnp.ndarray,
    config: ProjectiveMatcherConfig,
    force_stage: int = -1,
):
    """Frame-to-map tracking matcher (reference R3-R6).

    meas_*: fixed set (current measurements, [N, ...]); proj_*: projections
    of moving map points into the image ([M, ...]).  Returns
    (Matches over rows=measurements with idx into map points, stage) where
    ``stage`` is the chosen schedule index (host-readable tracking health).

    ``force_stage >= 0`` pins the schedule stage instead of the adaptive
    choice — the tracker drives a coarse-to-fine schedule across its
    re-association rounds (loose radius while the motion prediction is
    cold, tight at the end), mirroring the reference's widen-on-loss /
    shrink-on-convergence radius dynamics
    (correspondence_finder_projective_base_impl.cpp:227-288).  The adaptive
    tightest-good-stage selection alone is biased: with a cold prediction
    only low-flow (far) points fall inside a tight radius and forward
    translation is systematically underestimated.
    """
    cost = distance_matrix(meas_desc, proj_desc).astype(jnp.float32)
    delta = meas_uv[:, None, :] - proj_uv[None, :, :]
    geo = _geometric_distance(delta, config.norm)
    base_valid = meas_valid[:, None] & proj_valid[None, :]
    num_meas = jnp.maximum(jnp.sum(meas_valid), 1)

    n_stages = len(config.radius_stages)
    if force_stage >= 0:
        s = min(force_stage, n_stages - 1)
        feasible = base_valid & (geo <= config.radius_stages[s])
        m = match_cost_matrix(
            cost, feasible, config.descriptor_stages[s], config.lowe_ratio
        )
        return m, jnp.int32(s)

    per_stage = []
    for s in range(n_stages):
        feasible = base_valid & (geo <= config.radius_stages[s])
        m = match_cost_matrix(
            cost, feasible, config.descriptor_stages[s], config.lowe_ratio
        )
        per_stage.append(m)
    counts = jnp.stack([m.count for m in per_stage])
    ratios = counts.astype(jnp.float32) / num_meas.astype(jnp.float32)
    good = ratios >= config.minimum_matching_ratio
    # tightest good stage; if none qualifies fall back to the loosest stage
    stage = jnp.where(jnp.any(good), jnp.argmax(good), n_stages - 1)
    idx = jnp.stack([m.idx for m in per_stage])[stage]
    distance = jnp.stack([m.distance for m in per_stage])[stage]
    mask = jnp.stack([m.mask for m in per_stage])[stage]
    return Matches(idx=idx, distance=distance, mask=mask), stage
