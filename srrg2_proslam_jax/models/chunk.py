"""Chunked SLAM stepping: B frames AND their split pipelines in ONE program.

Motivation: every executable invocation and every host readback has a
fixed cost regardless of compute size, so a per-frame or per-split
dispatch cadence pays it once per frame.  Running B frames per program
amortizes launch overhead and host syncs (SURVEY.md §7.3 hard parts 4/6):

``fused_image_chunk_op`` / ``fused_meas_chunk_op`` — ONE jit per B frames:

  * the batched stereo/RGB-D adaptor over the chunk's images, then a
    ``lax.scan`` of the fused tracker step WITH the
    reference's per-frame status machine (Initializing/Tracking/Lost,
    app_benchmark.cpp:123-178) and the viewpoint splitting criterion
    (kitti.conf:542-550) evaluated ON DEVICE;
  * a post-scan split pass (``lax.fori_loop`` over the chunk's frames,
    each split gated by ``lax.cond`` so splitless chunks pay nothing):
    everything the reference does when a local map finishes
    (app_benchmark.cpp:136-161) — new-map pose + odometry factor with map
    ids as DEVICE counters, budget selection + closure-database insert,
    the fused loop query + K-candidate validation under the exact
    kitti.conf acceptance gates, closure-factor insertion, and conditional
    global PGO — runs inside the SAME program;
  * the host reads ONE flat f32 packet per chunk carrying the per-frame
    status rows and, per split, the complete deferred decision (map ids,
    edge cursor, db insert report, K validation rows).  No per-split
    dispatch, no second readback.

Relocalization (rare) stays host-arbitrated: the decision rows ride the
chunk packet, and on acceptance the orchestrator replays the chunk from its
stored input refs with ``hi = finish + 1`` (bit-identical device carries at
the split) and runs ``reloc_op`` — one extra dispatch per relocalization.

Frame-level math is IDENTICAL to models/tracker.track_step driven by the
synchronous orchestrator — pinned by tests/test_chunked.py equivalence.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import pgo
from ..ops import se3
from ..ops.pinhole import Camera
from . import landmarks as lm
from . import loop_closure
from .frontend import adapt_rgbd_batch, adapt_stereo_batch
from .tracker import TrackerConfig, TrackerState, initial_state, track_step

# ---------------------------------------------------------------------------
# per-frame packet layout ([PACKET_SIZE] f32, one row per frame)
# ---------------------------------------------------------------------------
PKT_INLIERS = 0
PKT_TRANS = 1
PKT_ROT = 2
PKT_MATCHES = 3
PKT_MERGES = 4
PKT_ADDITIONS = 5
PKT_CHI = 6
PKT_STAGE = 7
PKT_FINISH = 8        # 0 = none, 1 = split, 2 = lost
PKT_ACTIVE = 9        # 0 = frame outside the [lo, hi) active window
PKT_T = 10            # 10..21: pre-reset T_lm_robot[:3, :] row-major
PKT_VEL = 22          # 22..27: post-frame velocity twist
PACKET_SIZE = 28

FINISH_NONE = 0.0
FINISH_SPLIT = 1.0
FINISH_LOST = 2.0

# ---------------------------------------------------------------------------
# per-frame split-meta layout ([SM_CP + 22K] f32, appended to the packet)
# ---------------------------------------------------------------------------
SM_DID = 0        # 1.0 when this frame finished a local map
SM_PREV = 1       # id of the finished map
SM_NEW = 2        # id of the map opened after it
SM_ODO = 3        # edge slot of the odometry factor prev -> new
SM_EDGES = 4      # edge count AFTER this split (odometry + closure factors)
SM_DBN = 5        # budget-selected descriptor rows of the finished map
SM_INS = 6        # 1.0 when those rows were inserted into the database
SM_EVICTED = 7    # map id the ring insertion overwrote (-1: none)
SM_DBNEXT = 8     # ring cursor after this split
SM_CP = 9         # then K rows of 22 (loop_closure.detect_and_validate)


def split_meta_size(max_candidates: int) -> int:
    return SM_CP + 22 * max_candidates


class ChunkCarry(NamedTuple):
    """Device-resident SLAM state threaded through the fused chunk ops."""

    state: TrackerState
    frames_in_map: jnp.ndarray   # [] int32
    graph: pgo.PoseGraph
    edge_count: jnp.ndarray      # [] int32
    db: loop_closure.DescriptorDatabase
    current_map: jnp.ndarray     # [] int32
    num_maps: jnp.ndarray        # [] int32


class ChunkYs(NamedTuple):
    """Per-chunk outputs. ``packet`` is the ONE host-read array; everything
    else stays on device (mirrors slice it lazily, reloc replays use it)."""

    packet: jnp.ndarray        # [B*(PACKET_SIZE + SM)] flat f32
    arenas: lm.LandmarkArena   # [B, ...] post-update (pre-reset) arenas
    match_idx: jnp.ndarray     # [B, N] int32 (local BA / diagnostics)
    match_mask: jnp.ndarray    # [B, N] bool
    split_desc: jnp.ndarray    # [B, budget, 256] i8 db rows of finished maps
    split_pos: jnp.ndarray     # [B, budget, 3]
    split_rows: jnp.ndarray    # [B, budget] i32 arena rows
    loop_row: jnp.ndarray      # [B, K, Q] i32 closure corresp. (reloc)
    loop_mask: jnp.ndarray     # [B, K, Q] bool
    loop_T: jnp.ndarray        # [B, K, 4, 4] validated closure transforms


class _ScanYs(NamedTuple):
    packets: jnp.ndarray       # [B, PACKET_SIZE] f32
    arenas: lm.LandmarkArena
    match_idx: jnp.ndarray
    match_mask: jnp.ndarray


def _tree_select(pred, a, b):
    """Scalar-predicate select over two identical pytrees."""
    return jax.tree_util.tree_map(lambda x, y: jnp.where(pred, x, y), a, b)


@jax.jit
def take_frames(tree, idxs):
    """Jitted leading-axis gather over a pytree: rows ``idxs`` of each leaf.

    The chunked consume path compacts every split-containing chunk's
    outputs to ONE [n_splits, ...] stack per chunk (one dispatch), so the
    host mirrors hold n_splits frames instead of pinning the whole [B]
    chunk output on device indefinitely (VERDICT r4 weak #2)."""
    return jax.tree_util.tree_map(lambda x: x[idxs], tree)


@jax.jit
def take_frame(tree, i):
    """Jitted leading-axis index over a pytree (or a single array).

    Host-side mirror bookkeeping slices per-frame rows out of the chunk
    outputs; when the orchestrator runs on a mesh those outputs carry
    SPMD shardings and the EAGER gather path aborts inside XLA:CPU
    (measured round 4: Fatal abort in apply_primitive at relocalization) —
    a jitted index compiles through the partitioner instead.
    """
    return jax.tree_util.tree_map(lambda x: x[i], tree)


def _scan_body(state: TrackerState, frames_in_map, pts, desc, valid, active,
               cam: Camera, tcfg: TrackerConfig, model: str,
               min_track_inliers: int, max_translation: float,
               max_rotation: float):
    """One frame of the chunk: tracker step + on-device status machine.

    The tracker step runs under ``lax.cond(active, ...)`` so INACTIVE
    frames (outside the chunk's [lo, hi) window: the padded tail, the
    pre-``lo`` prefix of a post-relocalization rewind chunk, and the
    post-``hi`` suffix of a replay) cost a carry passthrough instead of a
    full ~2 ms tracker step — a relocalization replay of ``hi = i + 1``
    frames pays for ``i + 1`` steps, not B (measured round 5: the replay
    invocation was ~18% of the bench wall)."""

    def run_frame(_):
        new_state, stats, _X = track_step(state, pts, desc, valid, cam,
                                          tcfg, model)
        initializing = frames_in_map == 0
        lost = (~initializing) & (stats.num_inliers < min_track_inliers)
        split = ((~initializing) & (~lost)
                 & ((stats.trans_in_map > max_translation)
                    | (stats.rot_in_map > max_rotation)))
        finish = lost | split

        # reset on finish: fresh arena, identity pose; split keeps the
        # velocity, lost zeroes it (models/slam.py::_handle_lost /
        # reference matcher total-loss recovery)
        fresh = initial_state(state.arena.capacity,
                              estimator=tcfg.landmark_estimator)
        vel = jnp.where(lost, jnp.zeros(6, jnp.float32),
                        new_state.velocity)
        reset_state = fresh._replace(velocity=vel)
        next_state = _tree_select(finish, reset_state, new_state)
        next_fim = jnp.where(finish, 0, frames_in_map + 1)

        finish_code = jnp.where(
            finish, jnp.where(lost, FINISH_LOST, FINISH_SPLIT), FINISH_NONE)
        packet = jnp.concatenate([
            jnp.stack([
                stats.num_inliers.astype(jnp.float32),
                stats.trans_in_map,
                stats.rot_in_map,
                stats.num_matches.astype(jnp.float32),
                stats.num_merges.astype(jnp.float32),
                stats.num_additions.astype(jnp.float32),
                stats.chi_per_inlier,
                stats.matcher_stage.astype(jnp.float32),
                finish_code,
                jnp.float32(1.0),
            ]),
            new_state.T_lm_robot[:3, :].reshape(12),
            new_state.velocity,
        ])
        ys = _ScanYs(
            packets=packet,
            arenas=new_state.arena,  # pre-reset: the finished map on finish
            match_idx=stats.match_idx,
            match_mask=stats.match_mask,
        )
        return next_state, next_fim, ys

    def skip_frame(_):
        # PKT_ACTIVE = 0 makes both the split pass and the host consume
        # path ignore this row; the ys payloads are never read
        packet = jnp.zeros((PACKET_SIZE,), jnp.float32)
        ys = _ScanYs(
            packets=packet,
            arenas=state.arena,
            match_idx=jnp.full((pts.shape[0],), -1, jnp.int32),
            match_mask=jnp.zeros((pts.shape[0],), bool),
        )
        return state, frames_in_map, ys

    return jax.lax.cond(active, run_frame, skip_frame, None)


# ---------------------------------------------------------------------------
# post-scan split pass: the reference's split block, on device, per chunk
# ---------------------------------------------------------------------------

def _split_pass(graph: pgo.PoseGraph, edge_count, db, current_map, num_maps,
                ys: _ScanYs, chunk_size: int,
                loop_cfg: loop_closure.LoopDetectorConfig,
                pgo_cfg: pgo.PGOConfig, budget: int, enable_loop: bool):
    """Run the split pipeline for every frame that finished a local map.

    Mirrors the reference top loop's split block
    (app_benchmark.cpp:136-161): makeNewMap pose + odometry factor (map ids
    are device counters), database insert (skipped — and reported — when
    the database is full; the host evicts and rebuilds), loopDetect /
    loopValidate (K candidates, acceptance gates kitti.conf:970-977),
    closure factors for every accepted candidate, conditional global PGO.
    The ``lax.fori_loop`` body compiles ONCE; ``lax.cond`` skips it at
    runtime for frames without a finish.
    """
    B = chunk_size
    K = loop_cfg.max_candidates
    Q = ys.arenas.pos.shape[1]
    E = graph.edge_capacity
    num_maps_cap = graph.capacity
    K_eff = min(K, num_maps_cap)
    SM = split_meta_size(K)
    eyeK = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (K, 4, 4))
    cpacket0 = jnp.zeros((K, 22), jnp.float32).at[:, 0].set(-1.0)
    mrow0 = jnp.full((K, Q), -1, jnp.int32)
    mmask0 = jnp.zeros((K, Q), bool)

    def pad_k(a, template):
        return (a if a.shape[0] == K
                else jnp.concatenate([a, template[a.shape[0]:]], 0))

    def split_branch(j, c):
        (g, ec, db0, cur, nm, meta, sdesc, spos, srows,
         lrow, lmask, lT) = c
        pkt = ys.packets[j]
        lost = pkt[PKT_FINISH] == FINISH_LOST
        T_fin = jnp.concatenate([
            pkt[PKT_T:PKT_T + 12].reshape(3, 4),
            jnp.array([[0.0, 0.0, 0.0, 1.0]], jnp.float32),
        ], 0)
        arena = jax.tree_util.tree_map(lambda x: x[j], ys.arenas)
        prev, new = cur, nm

        # makeNewMap: pose chain + odometry factor (Z == T_fin by def.)
        pose_new = g.poses[prev] @ T_fin
        g = pgo.add_pose(g, new, pose_new)
        odo_slot = ec
        g = pgo.add_edge(g, odo_slot, prev, new, T_fin)
        ec = ec + 1

        # budget selection; the same rows feed the db insert and the mirror
        desc_b, pts_b, rows_b, valid_b, n_b = loop_closure.select_db_rows(
            arena.desc, arena.pos, arena.valid, arena.num_updates,
            budget=budget)

        if enable_loop:
            already = jnp.any(db0.map_id == prev)
            do_ins = ~already
            # ring insertion: when the slot is occupied its map is evicted
            # (reported so the host mirrors it — no rebuild machinery)
            slot = jax.lax.rem(db0.next, jnp.int32(db0.num_slots))
            evicted = jnp.where(do_ins, db0.map_id[slot], jnp.int32(-1))
            db1 = jax.lax.cond(
                do_ins,
                lambda d: loop_closure.add_local_map(
                    d, desc_b, pts_b, valid_b, prev, rows_b),
                lambda d: d, db0)

            def with_loop(g, ec):
                # query + validation on the FULL arena (budget-sized queries
                # starve the vote count — measured round 3)
                result, closures, cp = loop_closure.detect_and_validate(
                    arena.desc, arena.valid, arena.pos, prev, db1,
                    g.poses, loop_cfg, num_maps_cap)
                accepted = closures.accepted & (result.candidate_maps >= 0)
                # candidate-agreement gate (backstop part 1, see
                # LoopDetectorConfig.backstop_agreement_tolerance): the
                # implied query positions of all accepted candidates must
                # form a majority cluster; a 1-vs-1 disagreement (the
                # true + aliased pair) rejects both
                tol = loop_cfg.backstop_agreement_tolerance
                if loop_cfg.backstop_max_edge_residual > 0 and tol > 0:
                    T_impl = (g.poses[jnp.maximum(result.candidate_maps, 0)]
                              @ closures.T_query_in_ref)
                    t_impl = T_impl[:, :3, 3]
                    d_ab = jnp.linalg.norm(
                        t_impl[:, None, :] - t_impl[None, :, :], axis=-1)
                    agree = ((d_ab <= tol)
                             & accepted[:, None] & accepted[None, :])
                    score = jnp.sum(agree, axis=1)
                    n_acc = jnp.sum(accepted)
                    max_score = jnp.max(jnp.where(accepted, score, 0))
                    accepted = accepted & (score == max_score) & (
                        (max_score >= 2) | (n_acc <= 1))

                def pad(a):
                    return jnp.concatenate(
                        [a, jnp.zeros((1,) + a.shape[1:], a.dtype)], 0)

                def insert_and_optimize(acc):
                    offs = jnp.cumsum(acc.astype(jnp.int32)) - 1
                    slot = jnp.where(acc, ec + offs, E)
                    gi = g._replace(
                        edge_i=pad(g.edge_i).at[slot].set(
                            result.candidate_maps)[:E],
                        edge_j=pad(g.edge_j).at[slot].set(
                            jnp.int32(prev))[:E],
                        edge_Z=pad(g.edge_Z).at[slot].set(
                            closures.T_query_in_ref)[:E],
                        edge_weight=pad(g.edge_weight).at[slot].set(1.0)[:E],
                        edge_valid=pad(g.edge_valid).at[slot].set(True)[:E],
                    )
                    gi = jax.lax.cond(
                        jnp.any(acc),
                        lambda gg: pgo.optimize(gg, pgo_cfg)[0],
                        lambda gg: gg, gi)
                    return gi, slot

                # geometric backstop (beats the reference's failure mode
                # under periodic texture, kitti.conf:970-977): greedy
                # chi-style outlier pruning — insert the candidates, run
                # PGO, and while any closure edge's OWN post-PGO residual
                # (a false closure stays unsatisfied) or the held-out mean
                # over the pre-existing factors (a false closure the
                # solver DID follow bends the chain) exceeds the bound,
                # drop the worst offender and re-optimize from the
                # pristine graph.  All-or-nothing if the budget runs out.
                thr = loop_cfg.backstop_max_edge_residual
                if thr > 0:
                    Kk = accepted.shape[0]
                    held_out = jnp.arange(E, dtype=jnp.int32) < ec
                    # chain check is RELATIVE to the pre-insertion state:
                    # earlier PGOs legitimately leave redistributed drift
                    # in the odometry factors, so the bound is on how much
                    # the new closures WORSEN the held-out consistency
                    base_chain = pgo.mean_edge_residual(g, held_out)
                    # drop ORDER is the pre-insertion closure-vs-odometry
                    # residual: post-PGO residuals sit at a compromise
                    # equilibrium between conflicting closures (the
                    # saturated kernel bounds but never zeroes a false
                    # edge's pull), while pre-insertion the false closure
                    # carries drift + the aliasing offset and the true one
                    # only drift — a robust ranking
                    M_pre = (se3.inverse(closures.T_query_in_ref)
                             @ se3.inverse(g.poses[jnp.maximum(
                                 result.candidate_maps, 0)])
                             @ g.poses[prev])
                    pre_r = jnp.linalg.norm(M_pre[:, :3, 3], axis=-1)

                    def bs_cond(c):
                        acc, _, done, it = c
                        return (~done) & (it < Kk + 1)

                    def bs_body(c):
                        acc, _, _, it = c
                        g_i, slot = insert_and_optimize(acc)
                        r_all = pgo.edge_t_residuals(g_i)
                        chain_bad = (pgo.mean_edge_residual(g_i, held_out)
                                     > base_chain + thr)
                        self_r = jnp.where(
                            acc, r_all[jnp.clip(slot, 0, E - 1)], -jnp.inf)
                        bad = chain_bad | jnp.any(self_r > thr)
                        worst = jnp.argmax(jnp.where(acc, pre_r, -jnp.inf))
                        acc2 = jnp.where(jnp.arange(Kk) == worst,
                                         acc & ~bad, acc)
                        return acc2, g_i, ~bad, it + 1

                    accepted2, g_bs, done, _ = jax.lax.while_loop(
                        bs_cond, bs_body,
                        (accepted, g, jnp.bool_(False), jnp.int32(0)))
                    # budget exhausted while still bad: reject everything
                    accepted2 = accepted2 & done
                    g3 = _tree_select(done, g_bs, g)
                else:
                    accepted2 = accepted
                    g3, _ = insert_and_optimize(accepted)
                ec2 = ec + jnp.sum(accepted2)
                # backstop-rejected candidates report accepted = -1 so the
                # host can count them without a second readback
                cp = cp.at[:, 1].set(jnp.where(
                    accepted2, cp[:, 1],
                    jnp.where(cp[:, 1] > 0.5, -1.0, cp[:, 1])))
                return (g3, ec2, pad_k(cp, cpacket0),
                        pad_k(result.match_row, mrow0),
                        pad_k(result.match_mask, mmask0),
                        pad_k(closures.T_query_in_ref, eyeK))

            def without_loop(g, ec):
                return g, ec, cpacket0, mrow0, mmask0, eyeK

            do_loop = (~lost) & (nm >= 2)
            g, ec, cp, mrow, mmask, mT = jax.lax.cond(
                do_loop, with_loop, without_loop, g, ec)
        else:
            db1 = db0
            do_ins = jnp.bool_(False)
            evicted = jnp.int32(-1)
            cp, mrow, mmask, mT = cpacket0, mrow0, mmask0, eyeK

        head = jnp.stack([
            jnp.float32(1.0),
            prev.astype(jnp.float32), new.astype(jnp.float32),
            odo_slot.astype(jnp.float32), ec.astype(jnp.float32),
            n_b.astype(jnp.float32), do_ins.astype(jnp.float32),
            evicted.astype(jnp.float32), db1.next.astype(jnp.float32),
        ])
        meta = meta.at[j].set(jnp.concatenate([head, cp.reshape(-1)]))
        return (g, ec, db1, new, nm + 1,
                meta, sdesc.at[j].set(desc_b), spos.at[j].set(pts_b),
                srows.at[j].set(rows_b), lrow.at[j].set(mrow),
                lmask.at[j].set(mmask), lT.at[j].set(mT))

    def body(j, c):
        pkt = ys.packets[j]
        do = (pkt[PKT_FINISH] > 0.5) & (pkt[PKT_ACTIVE] > 0.5)
        return jax.lax.cond(do, lambda cc: split_branch(j, cc),
                            lambda cc: cc, c)

    init = (
        graph, edge_count, db, current_map, num_maps,
        jnp.zeros((B, SM), jnp.float32),
        jnp.full((B, budget, lm.DESC_BITS), -1, jnp.int8),
        jnp.zeros((B, budget, 3), jnp.float32),
        jnp.zeros((B, budget), jnp.int32),
        jnp.full((B, K, Q), -1, jnp.int32),
        jnp.zeros((B, K, Q), bool),
        jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, K, 4, 4)),
    )
    return jax.lax.fori_loop(0, B, body, init)


def _fused_chunk(carry: ChunkCarry, pts, desc, valid, lo, hi,
                 cam: Camera, tcfg: TrackerConfig, model: str,
                 min_track_inliers: int, max_translation: float,
                 max_rotation: float,
                 loop_cfg: loop_closure.LoopDetectorConfig,
                 pgo_cfg: pgo.PGOConfig, budget: int, enable_loop: bool):
    def body(c, xs):
        st, fim, idx = c
        p, d, v = xs
        active = (idx >= lo) & (idx < hi)
        st2, fim2, ys = _scan_body(
            st, fim, p, d, v, active, cam, tcfg, model,
            min_track_inliers, max_translation, max_rotation)
        return (st2, fim2, idx + 1), ys

    (state, fim, _), ys = jax.lax.scan(
        body, (carry.state, carry.frames_in_map, jnp.int32(0)),
        (pts, desc, valid))
    B = pts.shape[0]
    (graph, ec, db, cur, nm, meta, sdesc, spos, srows, lrow, lmask, lT) = \
        _split_pass(carry.graph, carry.edge_count, carry.db,
                    carry.current_map, carry.num_maps, ys, B,
                    loop_cfg, pgo_cfg, budget, enable_loop)
    flat = jnp.concatenate([ys.packets.reshape(-1), meta.reshape(-1)])
    out_carry = ChunkCarry(state, fim, graph, ec, db, cur, nm)
    out_ys = ChunkYs(flat, ys.arenas, ys.match_idx, ys.match_mask,
                     sdesc, spos, srows, lrow, lmask, lT)
    return out_carry, out_ys


def _fused_chunk_group(carry: ChunkCarry, get_chunk, lo, hi, B: int,
                       G: int, args):
    """Run ``G`` sequential B-frame chunks inside ONE device program.

    Grouping keeps the inner B-frame program shape bit-identical and
    amortizes one launch over ``G*B`` frames via a ``lax.scan`` over whole
    chunks; the body compiles once.  ``lo``/``hi`` are in group-frame
    coordinates [0, G*B).

    ``get_chunk(g)`` returns the g-th chunk's (pts, desc, valid) — for the
    image op it runs the batched adaptor inside the scan body.
    """
    if G == 1:
        pts, desc, valid = get_chunk(jnp.int32(0))
        return _fused_chunk(carry, pts, desc, valid, lo, hi, *args)

    def body(c, g):
        pts, desc, valid = get_chunk(g)
        lo_g = jnp.clip(lo - g * B, 0, B)
        hi_g = jnp.clip(hi - g * B, 0, B)
        return _fused_chunk(c, pts, desc, valid, lo_g, hi_g, *args)

    carry2, ys_g = jax.lax.scan(body, carry, jnp.arange(G, dtype=jnp.int32))
    # de-interleave the per-chunk flat packets into one [G*B]-frame packet
    # with the layout _consume_chunk expects (all packet rows, then all
    # split-meta rows)
    ps_b = B * PACKET_SIZE
    packets = ys_g.packet[:, :ps_b].reshape(G * B, PACKET_SIZE)
    meta = ys_g.packet[:, ps_b:].reshape(G * B, -1)
    flat = jnp.concatenate([packets.reshape(-1), meta.reshape(-1)])

    def fix(x):
        return x.reshape((G * x.shape[1],) + x.shape[2:])

    return carry2, ChunkYs(
        flat, jax.tree_util.tree_map(fix, ys_g.arenas),
        fix(ys_g.match_idx), fix(ys_g.match_mask), fix(ys_g.split_desc),
        fix(ys_g.split_pos), fix(ys_g.split_rows), fix(ys_g.loop_row),
        fix(ys_g.loop_mask), fix(ys_g.loop_T))


@partial(jax.jit, static_argnames=(
    "cam", "acfg", "tcfg", "model", "chunk_size", "min_track_inliers",
    "max_translation", "max_rotation", "loop_cfg", "pgo_cfg", "budget",
    "enable_loop", "group_size"))
def fused_image_chunk_op(
    carry: ChunkCarry,
    a_all: jnp.ndarray,     # [T, H, W] left / intensity image sequence
    b_all: jnp.ndarray,     # [T, H, W] right / raw-depth image sequence
    start,                  # [] int32: first frame of this chunk in a_all
    lo,                     # [] int32: first ACTIVE frame within the chunk
    hi,                     # [] int32: end of the active window (<= B)
    cam: Camera,
    acfg,                   # StereoAdaptorConfig | DepthAdaptorConfig
    tcfg: TrackerConfig,
    model: str,
    chunk_size: int,
    min_track_inliers: int,
    max_translation: float,
    max_rotation: float,
    loop_cfg: loop_closure.LoopDetectorConfig,
    pgo_cfg: pgo.PGOConfig,
    budget: int,
    enable_loop: bool,
    group_size: int = 1,
):
    """``group_size`` B-frame chunks + their splits in one device program
    (image front end).

    ``lo``/``hi`` implement replay (relocalization restart mid-chunk) and
    the padded final chunk without recompilation: frames outside [lo, hi)
    pass the carry through untouched and are flagged inactive in their
    packet.  Returns (ChunkCarry', ChunkYs) with ``group_size * B`` frame
    rows.
    """
    B = chunk_size

    def get_chunk(g):
        a = jax.lax.dynamic_slice_in_dim(a_all, start + g * B, B, 0)
        b = jax.lax.dynamic_slice_in_dim(b_all, start + g * B, B, 0)
        # batched adaptors, NOT vmap(adapt_*): detection batches through
        # one 2-D top_k (ops/features.detect_keypoints_batch)
        if model == "stereo":
            meas = adapt_stereo_batch(a, b, acfg)
        else:
            meas = adapt_rgbd_batch(a, b, acfg)
        return meas.points, meas.desc, meas.valid

    return _fused_chunk_group(
        carry, get_chunk, lo, hi, B, group_size,
        (cam, tcfg, model, min_track_inliers, max_translation,
         max_rotation, loop_cfg, pgo_cfg, budget, enable_loop))


@partial(jax.jit, static_argnames=(
    "cam", "tcfg", "model", "chunk_size", "min_track_inliers",
    "max_translation", "max_rotation", "loop_cfg", "pgo_cfg", "budget",
    "enable_loop", "group_size"))
def fused_meas_chunk_op(
    carry: ChunkCarry,
    points_all: jnp.ndarray,    # [T, N, D] pre-adapted measurement sequence
    desc_all: jnp.ndarray,      # [T, N, 256]
    valid_all: jnp.ndarray,     # [T, N]
    start, lo, hi,
    cam: Camera,
    tcfg: TrackerConfig,
    model: str,
    chunk_size: int,
    min_track_inliers: int,
    max_translation: float,
    max_rotation: float,
    loop_cfg: loop_closure.LoopDetectorConfig,
    pgo_cfg: pgo.PGOConfig,
    budget: int,
    enable_loop: bool,
    group_size: int = 1,
):
    """Fused chunk over pre-adapted measurement sequences (synthetic/tests)."""
    B = chunk_size

    def get_chunk(g):
        pts = jax.lax.dynamic_slice_in_dim(points_all, start + g * B, B, 0)
        desc = jax.lax.dynamic_slice_in_dim(desc_all, start + g * B, B, 0)
        valid = jax.lax.dynamic_slice_in_dim(valid_all, start + g * B, B, 0)
        return pts, desc, valid

    return _fused_chunk_group(
        carry, get_chunk, lo, hi, B, group_size,
        (cam, tcfg, model, min_track_inliers, max_translation,
         max_rotation, loop_cfg, pgo_cfg, budget, enable_loop))


# ---------------------------------------------------------------------------
# relocalization carry rollback: undo later finishes without a chunk replay
# ---------------------------------------------------------------------------

@jax.jit
def undo_graph_entries(graph: pgo.PoseGraph, dead_poses, dead_edges):
    """Invalidate the poses/odometry edges later finishes speculatively
    added (indices >= capacity are padding — scatter drops them).

    Sound only when no later finish retained an accepted closure: closure
    acceptance rewrites every pose via PGO, which cannot be undone by
    invalidation (the orchestrator falls back to the bit-exact chunk
    replay there).  Values in the invalidated slots stay stale, exactly
    like ``reloc_op``'s dead-map retirement — every insertion writes both
    value and validity.
    """
    return graph._replace(
        pose_valid=graph.pose_valid.at[dead_poses].set(False),
        edge_valid=graph.edge_valid.at[dead_edges].set(False),
    )


@jax.jit
def db_write_slot(db: loop_closure.DescriptorDatabase, slot, desc, points,
                  rows, valid, map_id, next_val):
    """Overwrite one ring slot + cursor (reloc rollback of a later insert).

    Restores either the evicted map's budget stack (from the host mirror,
    re-filled to ``add_local_map``'s exact invalid-row padding) or a free
    slot (map_id -1, all-invalid).
    """
    return db._replace(
        desc=db.desc.at[slot].set(desc),
        points=db.points.at[slot].set(points),
        arena_row=db.arena_row.at[slot].set(rows),
        valid=db.valid.at[slot].set(valid),
        map_id=db.map_id.at[slot].set(jnp.int32(map_id)),
        next=jnp.int32(next_val),
    )


# ---------------------------------------------------------------------------
# relocalization op: reload an old local map through the closure
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("max_insertions", "estimator"))
def reloc_op(
    graph: pgo.PoseGraph,
    ref_arena: lm.LandmarkArena,     # the reloaded old map's arena
    query_arena: lm.LandmarkArena,   # the finished query map's arena
    T_candidates: jnp.ndarray,       # [K, 4, 4] validated closure transforms
    match_row: jnp.ndarray,          # [K, Q]
    match_mask: jnp.ndarray,         # [K, Q]
    k,                               # [] int32: accepted candidate index
    T_split: jnp.ndarray,            # [4, 4] robot in query map at the split
    velocity: jnp.ndarray,           # [6] post-split velocity twist
    dead_map,                        # speculatively-opened map to retire
    dead_edge_slot,                  # its odometry edge slot ([] int32)
    max_insertions: int,
    estimator: str,
):
    """Rebuild tracking inside a reloaded map (MultiRelocalizer3D analog).

    One dispatch: closure-correspondence merge of the query map into the
    reference arena (models/landmarks.merge_closure — the reference's
    tracker->setClosure flow), retirement of the speculatively-opened map's
    pose + odometry factor, and the new TrackerState.
    """
    T_qref = T_candidates[k]
    merged = lm.merge_closure(ref_arena, query_arena, T_qref, match_row[k],
                              match_mask[k], max_insertions)
    graph = graph._replace(
        pose_valid=graph.pose_valid.at[dead_map].set(False),
        edge_valid=graph.edge_valid.at[dead_edge_slot].set(False),
    )
    fresh = initial_state(ref_arena.capacity, estimator=estimator)
    state = fresh._replace(
        arena=merged,
        T_lm_robot=(T_qref @ T_split).astype(jnp.float32),
        velocity=velocity,
    )
    return graph, state
