"""Loop-closure detection: sharded Hamming descriptor database + SE3 validation.

Capability parity with the reference's loop-closing stack
(MultiLoopDetectorHBST3D + CorrespondenceFinderHBST_ + srrg_hbst BinaryTree256,
reference srrg2_proslam/src/srrg2_proslam/registration/correspondence_finders/
correspondence_finder_hbst.cpp:41-130 and configurations/kitti.conf:938-978) —
redesigned accelerator-first: the HBST binary search tree is replaced by
ONE dense [D_total, 256] descriptor arena queried with an int8 matmul
(SURVEY.md §7.2 step 7: brute-force popcount-matmul beats tree traversal on
an accelerator), which
also queries ALL stored local maps in a single shot exactly like the
reference's one-call-to-tree design.

Flow (mirrors SURVEY.md §3.5):
  1. on local-map split, the map's landmark descriptors + positions (plus
     their arena rows, for closure-correspondence merging) are appended to
     the database with their map id;
  2. a query matches the new map's descriptors against the whole database,
     gated by descriptor distance, Lowe ratio, and the minimum age
     difference (correspondence_finder_hbst.cpp:75-91);
  3. per-reference-map vote counts select the TOP-K candidate maps, and for
     EACH candidate the per-query best match *within that map* is extracted
     (the analog of the reference's per-reference correspondence extraction
     at correspondence_finder_hbst.cpp:95-128 — every qualifying reference
     map gets its own correspondence set, not just the global-argmax one);
  4. every candidate is validated by a point-to-point SE3 GN alignment
     (the "loop_aligner" MultiAligner3DQR with AlignerSliceProcessor3D and
     RobustifierClamp, kitti.conf:649-677) under the acceptance gates
     inliers >= 25, chi/inlier <= 2, inlier ratio >= 0.5
     (kitti.conf:970-977); all K validations run vmapped in one jit.

The database layout ([D, 256] int8 + int32 metadata) is shardable along D
across a device mesh (parallel/spmd.py): each device matches its slice and
the top-candidate reduction is a psum — the multi-host extension of the
same kernel.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import config as cfg
from ..ops import se3
from ..ops.hamming import distance_matrix
from ..ops.gn import gn_iterate, point3_system

# per-map best-match encoding: key = distance * _ROW_SHIFT + db_row.  The
# Hamming distance is integer <= 256 (sentinel 300 for infeasible), db rows
# stay below 2^22 (4M descriptors), so keys peak at 300 * 2^22 + 2^22 - 1
# ≈ 1.26e9 — comfortably inside int32.
_ROW_SHIFT = 1 << 22
_DIST_SENTINEL = 300


@cfg.register
class LoopDetectorConfig:
    """Mirrors MultiLoopDetectorHBST3D params (kitti.conf:938-978)."""

    maximum_descriptor_distance: float = 25.0
    minimum_age_difference: int = 10
    minimum_matches: int = 25
    # within-map Lowe ratio: a query row's best match in a reference map
    # must beat the second best in the SAME map by this ratio
    lowe_ratio: float = 0.8
    # number of candidate reference maps validated per query (the reference
    # validates every qualifying reference map,
    # correspondence_finder_hbst.cpp:95-128; K is the fixed-shape budget)
    max_candidates: int = 4
    # validation aligner (kitti.conf:649-677 "loop_aligner")
    aligner_iterations: int = 30
    chi_threshold: float = 3.0          # RobustifierClamp (kitti.conf:380-408)
    damping: float = 1.0
    # acceptance gates (kitti.conf:970-977)
    relocalize_min_inliers: int = 25
    relocalize_max_chi_inliers: float = 2.0
    relocalize_min_inliers_ratio: float = 0.5
    # geometric backstop BEYOND the reference's gates: after speculatively
    # inserting the accepted closures and running PGO, the mean
    # translational residual of the PRE-EXISTING factors (odometry +
    # earlier closures) must stay below this bound or the closures are
    # rejected and the graph reverted.  Under periodic texture a self-
    # consistent WRONG closure passes the reference's identical Lowe+chi
    # gates (kitti.conf:970-977) but bends the whole chain against its own
    # odometry; a true closure only redistributes drift.  <= 0 disables.
    backstop_max_edge_residual: float = 0.5
    # candidate-agreement gate (part of the same backstop): when >= 2
    # candidates validate into one query map, their implied query-map
    # world positions (T_candidate @ T_query_in_ref) must cluster within
    # this tolerance; candidates outside the majority cluster are
    # rejected, and a 1-vs-1 disagreement rejects both (precision first —
    # under perceptual aliasing with drift larger than the texture
    # period, odometry consistency alone CANNOT arbitrate, but a true and
    # an aliased closure always disagree with each other by the period)
    backstop_agreement_tolerance: float = 1.0
    # 0 = dense query (one [Q, S, budget] pass — fastest while it fits);
    # > 0 = scan the ring max(1, query_tile // budget) SLOTS at a time,
    # bounding query memory for arbitrarily large databases (bit-identical
    # results; the slot-group count must divide num_slots)
    query_tile: int = 0


class DescriptorDatabase(NamedTuple):
    """Slotted ring of local-map descriptor sets.

    Round-4 redesign: the flat row arena became [S slots x budget rows],
    ONE finalized local map per slot.  The per-(query, map) two-best
    extraction — formerly a scatter-min over encoded keys, 8.9 of the
    9.9 ms split-time query (measured round 4) — becomes a plain ``min``
    over the slot's budget axis, and insertion/eviction become a ring slot
    write (the oldest map is overwritten when the ring wraps; no host-side
    evict-and-rebuild).
    """

    desc: jnp.ndarray       # [S, budget, 256] int8 signed bits
    points: jnp.ndarray     # [S, budget, 3] landmark pos in its map frame
    arena_row: jnp.ndarray  # [S, budget] int32 row in the owning map's arena
    valid: jnp.ndarray      # [S, budget] bool
    map_id: jnp.ndarray     # [S] int32 owning local map (-1 = free slot)
    next: jnp.ndarray       # [] int32 ring cursor (total inserts ever)

    @property
    def num_slots(self) -> int:
        return self.map_id.shape[0]

    @property
    def budget(self) -> int:
        return self.desc.shape[1]

    @property
    def capacity(self) -> int:
        return self.num_slots * self.budget


def empty_database(capacity: int, budget: int = None) -> DescriptorDatabase:
    """Ring database holding ``capacity // budget`` local maps.

    ``budget`` = max descriptor rows per map (GraphSLAMConfig.
    max_db_descriptors_per_map); defaults to capacity/4 clamped to
    [1, 1024] so small test databases still hold several maps.
    """
    if budget is None:
        budget = max(1, min(1024, capacity // 4))
    budget = max(1, min(budget, capacity))
    S = max(1, capacity // budget)
    return DescriptorDatabase(
        desc=jnp.full((S, budget, 256), -1, jnp.int8),
        points=jnp.zeros((S, budget, 3), jnp.float32),
        arena_row=jnp.zeros((S, budget), jnp.int32),
        valid=jnp.zeros((S, budget), bool),
        map_id=jnp.full((S,), -1, jnp.int32),
        next=jnp.int32(0),
    )


@jax.jit
def add_local_map(
    db: DescriptorDatabase,
    desc: jnp.ndarray,      # [M, 256] int8
    points: jnp.ndarray,    # [M, 3] local-map frame
    valid: jnp.ndarray,     # [M] bool
    map_id,
    rows: jnp.ndarray = None,  # [M] int32 arena rows (default: arange)
) -> DescriptorDatabase:
    """Write one local map's landmarks into the next ring slot.

    Mirrors the reference's addPreviousQuery tree insertion
    (correspondence_finder_hbst.cpp:110-128).  The first ``budget`` valid
    rows win (callers pre-select by maturity via select_db_rows); when the
    ring is full the OLDEST map's slot is overwritten — eviction is
    implicit and the host mirrors it by insertion order.  ``rows`` carries
    the landmark-arena row of each input when the input is a compacted
    subset of the arena.
    """
    S, budget = db.num_slots, db.budget
    M = desc.shape[0]
    if rows is None:
        rows = jnp.arange(M, dtype=jnp.int32)
    rank = jnp.cumsum(valid.astype(jnp.int32)) - 1
    take = valid & (rank < budget)
    dest = jnp.where(take, rank, budget)  # overflow sink row

    def compact(a, fill):
        out = jnp.full((budget + 1,) + a.shape[1:], fill, a.dtype)
        return out.at[dest].set(a)[:budget]

    slot = jax.lax.rem(db.next, jnp.int32(S))
    return db._replace(
        desc=db.desc.at[slot].set(compact(desc, -1)),
        points=db.points.at[slot].set(compact(points, 0)),
        arena_row=db.arena_row.at[slot].set(compact(rows, 0)),
        valid=db.valid.at[slot].set(
            compact(jnp.ones((M,), bool), False)),
        map_id=db.map_id.at[slot].set(jnp.int32(map_id)),
        next=db.next + 1,
    )


class LoopQueryResult(NamedTuple):
    """Top-K candidate reference maps + per-candidate correspondences.

    All leading-K arrays are ordered by decreasing vote count; rows with
    candidate_maps == -1 are inactive (below the minimum_matches gate).
    """

    candidate_maps: jnp.ndarray  # [K] int32 reference map ids (-1 inactive)
    votes: jnp.ndarray           # [K] int32 global-best matches per candidate
    match_idx: jnp.ndarray       # [K, Q] int32 db row per query row (-1)
    match_row: jnp.ndarray       # [K, Q] int32 arena row in the ref map (-1)
    match_mask: jnp.ndarray      # [K, Q] bool
    match_points: jnp.ndarray    # [K, Q, 3] matched landmark in ref frame


def _slot_two_best(query_desc, query_valid, query_map_id, desc, valid,
                   map_id, slot_base, config: LoopDetectorConfig):
    """Per-(query, slot) encoded two-best over a [ts, budget] slot group.

    The slotted layout reduces per-map extraction to a ``min`` over each
    slot's budget axis — no scatter (the round-3 scatter-min was 8.9 ms of
    the 9.9 ms split-time query).  Keys encode (distance, flat db row);
    ``slot_base`` is the first slot's global index (tiling offset).
    """
    ts, budget = desc.shape[0], desc.shape[1]
    Q = query_desc.shape[0]
    sentinel = jnp.iinfo(jnp.int32).max
    cost = distance_matrix(query_desc, desc.reshape(ts * budget, -1))
    cost = cost.reshape(Q, ts, budget)
    age_ok = (((query_map_id - map_id) >= config.minimum_age_difference)
              & (map_id >= 0))                          # [ts]
    feasible = (query_valid[:, None, None] & valid[None]
                & age_ok[None, :, None])
    masked = jnp.where(feasible, cost, _DIST_SENTINEL)
    flat_row = ((slot_base + jnp.arange(ts, dtype=jnp.int32))[:, None]
                * budget + jnp.arange(budget, dtype=jnp.int32)[None, :])
    key = masked * _ROW_SHIFT + flat_row[None]          # [Q, ts, budget]
    best = jnp.min(key, axis=2)                         # [Q, ts]
    second = jnp.min(
        jnp.where(key == best[:, :, None], sentinel, key), axis=2)
    d1 = (best // _ROW_SHIFT).astype(jnp.float32)
    d2 = jnp.minimum(second // _ROW_SHIFT, _DIST_SENTINEL).astype(
        jnp.float32)
    vote_ok = (
        query_valid[:, None]
        & (d1 <= config.maximum_descriptor_distance)
        & (d1 <= config.lowe_ratio * d2)
    )
    votes = jnp.sum(vote_ok, axis=0).astype(jnp.int32)
    return votes, best, vote_ok


def query_terms(
    query_desc: jnp.ndarray,   # [Q, 256] int8
    query_valid: jnp.ndarray,  # [Q] bool
    query_map_id,              # current map id (age gating)
    db: DescriptorDatabase,
    config: LoopDetectorConfig,
):
    """Per-(query, slot) best match + vote histogram over the whole ring.

    Per-reference extraction (the analog of
    correspondence_finder_hbst.cpp:95-128): for EVERY stored map, each
    query row's best and second-best match *within that map's slot* gate a
    vote by descriptor distance and within-map Lowe ratio.  A query row
    can contribute correspondences to several overlapping maps — exactly
    the behavior the reference gets from merged HBST matchables.

    Returns (votes [S], per_slot_key [Q, S], vote_ok [Q, S]).  Shardable
    along the budget axis (parallel/spmd.py): each shard's partial min /
    vote sum reduce across shards.
    """
    return _slot_two_best(query_desc, query_valid, query_map_id,
                          db.desc, db.valid, db.map_id, jnp.int32(0),
                          config)


def query_terms_tiled(
    query_desc: jnp.ndarray,
    query_valid: jnp.ndarray,
    query_map_id,
    db: DescriptorDatabase,
    config: LoopDetectorConfig,
    tile_slots: int,
):
    """Constant-memory variant of ``query_terms`` (VERDICT r2 item 9).

    Scans the ring ``tile_slots`` slots at a time; because slot groups are
    disjoint maps, per-tile results simply CONCATENATE (bit-identical to
    the dense path).  Peak intermediate memory is [Q, tile_slots * budget]
    instead of [Q, S * budget].
    """
    S = db.num_slots
    if S % tile_slots != 0:
        raise ValueError(
            f"tile of {tile_slots} slots must divide num_slots {S}")
    n_tiles = S // tile_slots

    def body(_, inp):
        desc, valid, mid, t_idx = inp
        return None, _slot_two_best(
            query_desc, query_valid, query_map_id, desc, valid, mid,
            t_idx * tile_slots, config)

    _, (votes, best, vote_ok) = jax.lax.scan(
        body, None,
        (db.desc.reshape(n_tiles, tile_slots, db.budget, 256),
         db.valid.reshape(n_tiles, tile_slots, db.budget),
         db.map_id.reshape(n_tiles, tile_slots),
         jnp.arange(n_tiles, dtype=jnp.int32)),
    )
    Q = query_desc.shape[0]
    votes = votes.reshape(S)
    best = jnp.moveaxis(best, 0, 1).reshape(Q, S)
    vote_ok = jnp.moveaxis(vote_ok, 0, 1).reshape(Q, S)
    return votes, best, vote_ok


@partial(jax.jit, static_argnames=("config", "num_maps"))
def query(
    query_desc: jnp.ndarray,
    query_valid: jnp.ndarray,
    query_map_id,
    db: DescriptorDatabase,
    config: LoopDetectorConfig,
    num_maps: int = None,
) -> LoopQueryResult:
    """Match a local map against the whole database; return top-K candidates.

    ``num_maps`` only bounds K for callers that know few maps exist (shape
    compatibility with the pre-slotted API); the ring's slot count bounds
    it anyway.
    """
    S = db.num_slots
    if config.query_tile > 0:
        tile_slots = max(1, config.query_tile // db.budget)
        votes, per_slot_key, vote_ok = query_terms_tiled(
            query_desc, query_valid, query_map_id, db, config, tile_slots,
        )
    else:
        votes, per_slot_key, vote_ok = query_terms(
            query_desc, query_valid, query_map_id, db, config
        )
    K = min(config.max_candidates, S)
    if num_maps is not None:
        K = min(K, num_maps)
    top_votes, top_slots = jax.lax.top_k(votes, K)
    found = top_votes >= config.minimum_matches
    cands = jnp.where(found, db.map_id[top_slots], -1).astype(jnp.int32)

    keys = per_slot_key[:, top_slots].T                    # [K, Q]
    idx = keys % _ROW_SHIFT                                # flat db row
    mask = found[:, None] & vote_ok[:, top_slots].T
    idx_c = jnp.clip(idx, 0, db.capacity - 1)
    return LoopQueryResult(
        candidate_maps=cands,
        votes=top_votes,
        match_idx=jnp.where(mask, idx, -1).astype(jnp.int32),
        match_row=jnp.where(mask, db.arena_row.reshape(-1)[idx_c], -1),
        match_mask=mask,
        match_points=db.points.reshape(-1, 3)[idx_c],
    )


class ClosureResult(NamedTuple):
    """Per-candidate validation outputs (leading axis K when batched)."""

    T_query_in_ref: jnp.ndarray  # [.., 4, 4] transform of query map in ref frame
    num_inliers: jnp.ndarray
    chi_per_inlier: jnp.ndarray
    inlier_ratio: jnp.ndarray    # inliers / correspondences
    accepted: jnp.ndarray        # [..] bool — all gates passed


def _validate_one(query_points, match_points, match_mask, T_init,
                  config: LoopDetectorConfig) -> ClosureResult:
    weights = jnp.ones((query_points.shape[0],), jnp.float32)
    system = lambda X: point3_system(
        X, query_points, match_points, weights, match_mask,
        chi_threshold=config.chi_threshold,
    )
    X, stats = gn_iterate(
        system, T_init, config.aligner_iterations,
        damping=config.damping, min_inliers=config.relocalize_min_inliers,
    )
    n_corr = jnp.maximum(jnp.sum(match_mask), 1)
    chi_per_inlier = stats.chi_total / jnp.maximum(stats.num_inliers, 1)
    ratio = stats.num_inliers / n_corr
    accepted = (
        (stats.num_inliers >= config.relocalize_min_inliers)
        & (chi_per_inlier <= config.relocalize_max_chi_inliers)
        & (ratio >= config.relocalize_min_inliers_ratio)
    )
    return ClosureResult(
        T_query_in_ref=X,
        num_inliers=stats.num_inliers,
        chi_per_inlier=chi_per_inlier,
        inlier_ratio=ratio,
        accepted=accepted,
    )


@partial(jax.jit, static_argnames="config")
def validate(
    query_points: jnp.ndarray,   # [Q, 3] query-map frame
    match_points: jnp.ndarray,   # [Q, 3] ref-map frame
    match_mask: jnp.ndarray,     # [Q] bool
    T_init: jnp.ndarray,         # [4, 4] initial guess
    config: LoopDetectorConfig,
) -> ClosureResult:
    """Point-to-point SE3 validation of one closure candidate.

    The estimate maps query-map points into the reference-map frame
    (moving = query, fixed = reference), mirroring the loop_aligner slice
    (AlignerSliceProcessor3D, RobustifierClamp chi=3).
    """
    return _validate_one(query_points, match_points, match_mask, T_init, config)


@partial(jax.jit, static_argnames="budget")
def select_db_rows(arena_desc, arena_pos, arena_valid, arena_num_updates,
                   budget: int = 1024):
    """Compact the per-map database budget ON DEVICE (VERDICT r2 item 3).

    The most mature (highest num_updates) valid landmarks win; ties break
    by arena row (stable argsort) — identical selection to the former
    host-side ``_db_select_budget`` without the full-arena readback.
    Returns (desc [B,256], points [B,3], rows [B] int32, valid [B], n []).
    """
    key = jnp.where(arena_valid, -arena_num_updates, jnp.int32(1 << 30))
    order = jnp.argsort(key, stable=True)[:budget].astype(jnp.int32)
    sel_valid = arena_valid[order]
    return (arena_desc[order], arena_pos[order], order, sel_valid,
            jnp.sum(sel_valid).astype(jnp.int32))


def compact_arena(arena, budget: int):
    """Budget-compacted view of an arena + the selected rows.

    The compacted rows are a local map's REPRESENTATION in the closure
    subsystem: exactly the rows inserted into the database also form the
    query and closure-validation set — 4x less Hamming/GN work at the
    default budget vs querying the full arena, with the most mature (most
    re-observed, most reliable) landmarks doing the talking.  Returns
    (compacted LandmarkArena [budget], rows [budget] int32, n []).
    """
    from . import landmarks as lm

    desc_b, pts_b, rows_b, valid_b, n_b = select_db_rows(
        arena.desc, arena.pos, arena.valid, arena.num_updates,
        budget=budget)
    compact = lm.LandmarkArena(
        pos=pts_b,
        cov=arena.cov[rows_b],
        desc=desc_b,
        num_updates=arena.num_updates[rows_b],
        valid=valid_b,
    )
    return compact, rows_b, n_b


@partial(jax.jit, static_argnames=("config", "num_maps"))
def detect_and_validate(
    query_desc: jnp.ndarray,
    query_valid: jnp.ndarray,
    query_pos: jnp.ndarray,      # [Q, 3] query-map frame landmark positions
    query_map_id,
    db: DescriptorDatabase,
    poses: jnp.ndarray,          # [N, 4, 4] current graph estimates
    config: LoopDetectorConfig,
    num_maps: int,
):
    """Fused split-time loop detection: query + batched validation + packet.

    ONE dispatch producing everything the host decision needs in a single
    [K, 22] f32 ``packet`` (candidate id, accepted, num_inliers,
    chi_per_inlier, inlier_ratio, votes, T_query_in_ref.ravel()) so the
    orchestrator issues one async host copy and defers the closure /
    relocalization decision instead of blocking twice per split
    (VERDICT r2 items 1 and 3).  Returns (result, closures, packet).
    """
    result = query(query_desc, query_valid, query_map_id, db, config,
                   num_maps)
    T_init = jax.vmap(
        lambda c: se3.inverse(poses[jnp.maximum(c, 0)]) @ poses[query_map_id]
    )(result.candidate_maps)
    closures = validate_batch(query_pos, result, T_init, config)
    active = result.candidate_maps >= 0
    packet = jnp.concatenate([
        result.candidate_maps.astype(jnp.float32)[:, None],
        (closures.accepted & active).astype(jnp.float32)[:, None],
        closures.num_inliers.astype(jnp.float32)[:, None],
        closures.chi_per_inlier[:, None],
        closures.inlier_ratio[:, None],
        result.votes.astype(jnp.float32)[:, None],
        closures.T_query_in_ref.reshape(-1, 16),
    ], axis=1)
    return result, closures, packet


@partial(jax.jit, static_argnames="config")
def validate_batch(
    query_points: jnp.ndarray,   # [Q, 3] query-map frame
    result: LoopQueryResult,     # K candidates
    T_init: jnp.ndarray,         # [K, 4, 4] per-candidate initial guesses
    config: LoopDetectorConfig,
) -> ClosureResult:
    """Validate ALL top-K candidates in one vmapped jit.

    Mirrors the reference's loop over detected closures, each validated by
    the loop_aligner (app_benchmark.cpp:136-161) — here a single batched GN.
    """
    return jax.vmap(
        lambda mp, mm, Ti: _validate_one(query_points, mp, mm, Ti, config)
    )(result.match_points, result.match_mask, T_init)
