"""Closure-correspondence merging and multi-candidate closures at SLAM level.

Covers the reference's closure flow on relocalization: old local maps are
reloaded *through* the closure correspondences (tracker->setClosure at
reference srrg2_proslam/apps/app_benchmark.cpp:150-161, merged via the slice
flow of tracking/tracker_slice_processor_projective_depth.cpp:30-88), and
every qualifying reference map yields its own validated closure
(correspondence_finder_hbst.cpp:95-128).
"""
import numpy as np
import jax
import jax.numpy as jnp

from srrg2_proslam_jax.models import landmarks as lm
from srrg2_proslam_jax.models.loop_closure import LoopDetectorConfig
from srrg2_proslam_jax.models.slam import (
    GraphSLAM, GraphSLAMConfig, RelocalizerConfig, _PendingFrame,
)
from srrg2_proslam_jax.ops import se3
from tests.test_slam import CAM


def _filled_arena(capacity, pts, desc, num_updates=1):
    arena = lm.empty_arena(capacity)
    n = pts.shape[0]
    return arena._replace(
        pos=arena.pos.at[:n].set(jnp.asarray(pts)),
        desc=arena.desc.at[:n].set(jnp.asarray(desc)),
        cov=arena.cov.at[:n].set(jnp.eye(3) * 0.05),
        num_updates=arena.num_updates.at[:n].set(num_updates),
        valid=arena.valid.at[:n].set(True),
    )


def test_merge_closure_updates_and_inserts(rng):
    ref_pts = rng.uniform(-5, 5, (10, 3)).astype(np.float32)
    ref_desc = rng.choice(np.array([-1, 1], np.int8), size=(10, 256))
    ref = _filled_arena(32, ref_pts, ref_desc, num_updates=3)

    # query map displaced by a known transform; rows 0..4 correspond to
    # ref rows 0..4, rows 5..14 are new landmarks
    T_q_in_ref = np.asarray(se3.exp(jnp.array([1.0, 0.5, -0.2, 0, 0, 0.1])))
    T_ref_in_q = np.linalg.inv(T_q_in_ref)
    q_pts = rng.uniform(-5, 5, (15, 3)).astype(np.float32)
    q_pts[:5] = (ref_pts[:5] @ T_ref_in_q[:3, :3].T + T_ref_in_q[:3, 3])
    q_desc = rng.choice(np.array([-1, 1], np.int8), size=(15, 256))
    query = _filled_arena(32, q_pts, q_desc, num_updates=3)

    match_row = np.full(32, -1, np.int32)
    match_row[:5] = np.arange(5)
    match_mask = np.zeros(32, bool)
    match_mask[:5] = True

    merged = lm.merge_closure(
        ref, query, jnp.asarray(T_q_in_ref.astype(np.float32)),
        jnp.asarray(match_row), jnp.asarray(match_mask), max_insertions=64,
    )
    # matched rows: equal-weight mean of two coincident estimates == original
    np.testing.assert_allclose(np.asarray(merged.pos[:5]), ref_pts[:5],
                               atol=1e-4)
    # maturity accumulated, descriptor refreshed to the query observation
    assert np.all(np.asarray(merged.num_updates[:5]) == 6)
    np.testing.assert_array_equal(np.asarray(merged.desc[:5]), q_desc[:5])
    # unmatched rows 5..9 of ref untouched
    np.testing.assert_allclose(np.asarray(merged.pos[5:10]), ref_pts[5:10])
    assert np.all(np.asarray(merged.num_updates[5:10]) == 3)
    # the 10 unmatched query landmarks inserted (transformed into ref frame)
    assert int(merged.count) == 20
    ins = np.asarray(merged.pos[10:20])
    expect = q_pts[5:] @ T_q_in_ref[:3, :3].T + T_q_in_ref[:3, 3]
    # insertion order is maturity-ranked; compare as sets via sorted norms
    np.testing.assert_allclose(np.sort(np.linalg.norm(ins, axis=1)),
                               np.sort(np.linalg.norm(expect, axis=1)),
                               atol=1e-4)


def test_merge_closure_respects_capacity(rng):
    ref = _filled_arena(12, rng.uniform(-5, 5, (10, 3)).astype(np.float32),
                        rng.choice(np.array([-1, 1], np.int8), size=(10, 256)))
    q_pts = rng.uniform(-5, 5, (8, 3)).astype(np.float32)
    q_desc = rng.choice(np.array([-1, 1], np.int8), size=(8, 256))
    query = _filled_arena(12, q_pts, q_desc)
    merged = lm.merge_closure(
        ref, query, se3.identity(),
        jnp.full(12, -1, jnp.int32), jnp.zeros(12, bool), max_insertions=64,
    )
    assert int(merged.count) == 12  # only 2 free slots existed


def test_one_split_closes_to_two_distinct_maps(rng):
    """One query map must produce accepted closures to BOTH old maps."""
    pts = rng.uniform(-5, 5, (200, 3)).astype(np.float32) + [0, 0, 10]
    desc = rng.choice(np.array([-1, 1], np.int8), size=(200, 256))
    config = GraphSLAMConfig(
        loop=LoopDetectorConfig(minimum_age_difference=1,
                                minimum_matches=25),
        relocalizer=RelocalizerConfig(relocalize_min_inliers=10 ** 6),
        arena_capacity=256,
        database_capacity=4096,
        enable_loop_closing=True,
    )
    slam = GraphSLAM(CAM, config)
    arena = _filled_arena(256, pts, desc)
    for _ in range(3):  # maps 0, 1, 2 all observe the same landmarks
        slam._make_new_map(se3.identity())
        slam.tracker_state = slam.tracker_state._replace(arena=arena)
        if slam.current_map < 2:
            slam._finalize_current_map()
    slam._finalize_current_map()
    # dispatch + consume the deferred loop-closure decision directly (the
    # relocalizer gates are disabled above: this test pins the factor
    # bookkeeping, not the reload path)
    entry = _PendingFrame(meas=None, timestamp=0.0,
                          state=slam.tracker_state, stats=None, packet=None)
    marker = slam._dispatch_loop_query(entry, np.eye(4, dtype=np.float32))
    marker.new_map = -1
    marker.odo_edge_slot = -1
    slam._consume_marker(marker)
    assert slam.num_closures == 2
    # closure edges from the query map (2) to both references (0 and 1);
    # odometry edges 0->1 and 1->2 were added by _make_new_map
    ei = np.asarray(slam.graph.edge_i[:slam.num_edges])
    ej = np.asarray(slam.graph.edge_j[:slam.num_edges])
    closure_pairs = [(int(i), int(j)) for i, j in zip(ei, ej)]
    assert closure_pairs.count((0, 2)) == 1
    assert closure_pairs.count((1, 2)) == 2  # odometry 1->2 plus closure 1->2
