"""Loop-closure tests: database votes, gating, and closure validation.

Mirrors the reference loop-closing test design (synthetic worlds with exact
descriptors shared along GT correspondences, reference srrg2_proslam/tests/
test_loop_closing.cpp:38-136) with tolerance-based assertions instead of
exact match counts (SURVEY.md §4.3).
"""
import numpy as np
import jax
import jax.numpy as jnp

from srrg2_proslam_jax.models import loop_closure
from srrg2_proslam_jax.ops import se3


def _random_desc(rng, n):
    return rng.choice(np.array([-1, 1], np.int8), size=(n, 256))


def _flip_bits(rng, desc, k):
    """Flip k random bits per descriptor (controlled Hamming distance)."""
    out = desc.copy()
    for i in range(desc.shape[0]):
        idx = rng.choice(256, size=k, replace=False)
        out[i, idx] = -out[i, idx]
    return out


def test_query_finds_reference_map():
    rng = np.random.RandomState(0)
    cfg = loop_closure.LoopDetectorConfig(minimum_age_difference=1,
                                          minimum_matches=25)
    db = loop_closure.empty_database(512)
    desc0 = _random_desc(rng, 100)
    pts0 = rng.uniform(-5, 5, (100, 3)).astype(np.float32)
    db = loop_closure.add_local_map(
        db, jnp.asarray(desc0), jnp.asarray(pts0), jnp.ones(100, bool), 0
    )
    # decoy map with unrelated descriptors
    db = loop_closure.add_local_map(
        db, jnp.asarray(_random_desc(rng, 80)),
        jnp.zeros((80, 3), jnp.float32), jnp.ones(80, bool), 1
    )
    # query = map 0's descriptors with 5 flipped bits (distance 5 << 25)
    q_desc = _flip_bits(rng, desc0, 5)
    res = loop_closure.query(
        jnp.asarray(q_desc), jnp.ones(100, bool), 5, db, cfg, num_maps=8
    )
    assert int(res.candidate_maps[0]) == 0
    assert int(res.votes[0]) >= 80
    # correspondences carry the reference arena rows for closure merging
    rows = np.asarray(res.match_row[0])
    mask = np.asarray(res.match_mask[0])
    assert (rows[mask] == np.arange(100)[mask]).mean() > 0.9


def test_query_age_gate_blocks_recent_maps():
    rng = np.random.RandomState(1)
    cfg = loop_closure.LoopDetectorConfig(minimum_age_difference=10)
    db = loop_closure.empty_database(256)
    desc = _random_desc(rng, 60)
    db = loop_closure.add_local_map(
        db, jnp.asarray(desc), jnp.zeros((60, 3), jnp.float32),
        jnp.ones(60, bool), 3
    )
    # query map id 5: age difference 2 < 10 -> no candidate
    res = loop_closure.query(
        jnp.asarray(desc), jnp.ones(60, bool), 5, db, cfg, num_maps=8
    )
    assert int(res.candidate_maps[0]) == -1


def test_query_extracts_multiple_candidates():
    """Two overlapping reference maps must BOTH be extracted (the reference
    validates closures for every qualifying map,
    correspondence_finder_hbst.cpp:95-128)."""
    rng = np.random.RandomState(7)
    cfg = loop_closure.LoopDetectorConfig(minimum_age_difference=1,
                                          minimum_matches=25)
    db = loop_closure.empty_database(512)
    desc = _random_desc(rng, 120)
    pts = rng.uniform(-5, 5, (120, 3)).astype(np.float32)
    # map 0 stores rows 0..79, map 1 stores rows 40..119 (share 40..79)
    db = loop_closure.add_local_map(
        db, jnp.asarray(desc[:80]), jnp.asarray(pts[:80]),
        jnp.ones(80, bool), 0
    )
    db = loop_closure.add_local_map(
        db, jnp.asarray(desc[40:]), jnp.asarray(pts[40:]),
        jnp.ones(80, bool), 1
    )
    q = _flip_bits(rng, desc, 4)
    res = loop_closure.query(
        jnp.asarray(q), jnp.ones(120, bool), 12, db, cfg, num_maps=8
    )
    cands = sorted(int(c) for c in np.asarray(res.candidate_maps)[:2])
    assert cands == [0, 1]
    # per-map extraction: each candidate yields its own correspondences
    # (>= its row count at the distance gate), NOT only global-argmin rows
    n0 = int(res.match_mask[list(np.asarray(res.candidate_maps)).index(0)].sum())
    n1 = int(res.match_mask[list(np.asarray(res.candidate_maps)).index(1)].sum())
    assert n0 >= 75 and n1 >= 75


def test_validate_recovers_known_transform():
    rng = np.random.RandomState(2)
    cfg = loop_closure.LoopDetectorConfig(minimum_age_difference=0)
    # reference map points + the query map displaced by a known SE3
    pts_ref = rng.uniform(-5, 5, (120, 3)).astype(np.float32) + [0, 0, 10]
    T_q_in_ref = np.asarray(
        se3.exp(jnp.array([0.4, -0.2, 0.6, 0.02, -0.01, 0.05], jnp.float32))
    )
    T_ref_in_q = np.linalg.inv(T_q_in_ref)
    pts_query = (pts_ref @ T_ref_in_q[:3, :3].T + T_ref_in_q[:3, 3]).astype(np.float32)

    desc = _random_desc(rng, 120)
    db = loop_closure.empty_database(512)
    db = loop_closure.add_local_map(
        db, jnp.asarray(desc), jnp.asarray(pts_ref), jnp.ones(120, bool), 0
    )
    res = loop_closure.query(
        jnp.asarray(desc), jnp.ones(120, bool), 11, db, cfg, num_maps=8
    )
    assert int(res.candidate_maps[0]) == 0
    closure = loop_closure.validate(
        jnp.asarray(pts_query), res.match_points[0], res.match_mask[0],
        se3.identity(), cfg
    )
    assert bool(closure.accepted)
    assert float(closure.inlier_ratio) > 0.9
    t_err, ang = se3.error_t_and_angle(
        closure.T_query_in_ref, jnp.asarray(T_q_in_ref.astype(np.float32))
    )
    # reference bound: closure transform within (0.2, 0.2, 0.5) m, 0.01 rad
    # (test_loop_closing.cpp:128-135); noise-free synthetic is much tighter
    assert float(jnp.max(t_err)) < 1e-2
    assert float(ang) < 1e-3


def test_validate_batch_matches_single():
    rng = np.random.RandomState(5)
    cfg = loop_closure.LoopDetectorConfig(minimum_age_difference=1,
                                          minimum_matches=25)
    db = loop_closure.empty_database(512)
    desc = _random_desc(rng, 100)
    pts = (rng.uniform(-5, 5, (100, 3)) + [0, 0, 8]).astype(np.float32)
    db = loop_closure.add_local_map(
        db, jnp.asarray(desc), jnp.asarray(pts), jnp.ones(100, bool), 0
    )
    res = loop_closure.query(
        jnp.asarray(desc), jnp.ones(100, bool), 9, db, cfg, num_maps=8
    )
    T_init = jnp.broadcast_to(jnp.eye(4), (res.candidate_maps.shape[0], 4, 4))
    batch = loop_closure.validate_batch(jnp.asarray(pts), res, T_init, cfg)
    single = loop_closure.validate(
        jnp.asarray(pts), res.match_points[0], res.match_mask[0],
        se3.identity(), cfg
    )
    assert bool(batch.accepted[0]) == bool(single.accepted)
    np.testing.assert_allclose(np.asarray(batch.T_query_in_ref[0]),
                               np.asarray(single.T_query_in_ref), atol=1e-5)


def test_validate_rejects_garbage_geometry():
    rng = np.random.RandomState(3)
    cfg = loop_closure.LoopDetectorConfig(minimum_age_difference=0)
    pts_ref = rng.uniform(-5, 5, (80, 3)).astype(np.float32)
    desc = _random_desc(rng, 80)
    db = loop_closure.empty_database(256)
    db = loop_closure.add_local_map(
        db, jnp.asarray(desc), jnp.asarray(pts_ref), jnp.ones(80, bool), 0
    )
    res = loop_closure.query(
        jnp.asarray(desc), jnp.ones(80, bool), 11, db, cfg, num_maps=8
    )
    # query points geometrically unrelated to the matched reference points
    pts_garbage = rng.uniform(-50, 50, (80, 3)).astype(np.float32)
    closure = loop_closure.validate(
        jnp.asarray(pts_garbage), res.match_points[0], res.match_mask[0],
        se3.identity(), cfg
    )
    assert not bool(closure.accepted)


def test_sharded_query_matches_single_device():
    from srrg2_proslam_jax import parallel

    rng = np.random.RandomState(4)
    cfg = loop_closure.LoopDetectorConfig(minimum_age_difference=1)
    db = loop_closure.empty_database(256)
    desc = _random_desc(rng, 64)
    pts = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    db = loop_closure.add_local_map(
        db, jnp.asarray(desc), jnp.asarray(pts), jnp.ones(64, bool), 0
    )
    q = _flip_bits(rng, desc, 3)
    res1 = loop_closure.query(jnp.asarray(q), jnp.ones(64, bool), 5, db, cfg, 8)
    mesh = parallel.make_mesh(jax.devices()[:8])
    res2 = parallel.loop_query_spmd(
        mesh, jnp.asarray(q), jnp.ones(64, bool), 5, db, cfg, 8
    )
    assert int(res1.candidate_maps[0]) == int(res2.candidate_maps[0])
    assert int(res1.votes[0]) == int(res2.votes[0])
    np.testing.assert_array_equal(np.asarray(res1.match_idx),
                                  np.asarray(res2.match_idx))


def test_tiled_query_matches_dense():
    """query_tile > 0 must be bit-identical to the dense [Q, D] path."""
    rng = np.random.RandomState(7)
    db = loop_closure.empty_database(2048)
    for mid in range(4):
        n = 150 + 17 * mid
        db = loop_closure.add_local_map(
            db, jnp.asarray(_random_desc(rng, n)),
            jnp.asarray(rng.uniform(-5, 5, (n, 3)).astype(np.float32)),
            jnp.ones(n, bool), mid,
        )
    q_desc = jnp.asarray(_random_desc(rng, 128))
    q_valid = jnp.asarray(rng.rand(128) > 0.1)
    dense_cfg = loop_closure.LoopDetectorConfig(
        minimum_age_difference=1, minimum_matches=1,
        maximum_descriptor_distance=140.0, lowe_ratio=1.0)
    tiled_cfg = loop_closure.LoopDetectorConfig(
        minimum_age_difference=1, minimum_matches=1,
        maximum_descriptor_distance=140.0, lowe_ratio=1.0, query_tile=256)
    a = loop_closure.query(q_desc, q_valid, 6, db, dense_cfg, num_maps=8)
    b = loop_closure.query(q_desc, q_valid, 6, db, tiled_cfg, num_maps=8)
    for la, lb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


def test_tiled_query_large_capacity_constant_memory():
    """The tiled query runs at database_capacity=262144 ([Q, tile]
    intermediates only — the dense cost matrix would be [Q, 262144] int32)
    and still finds the right reference map."""
    rng = np.random.RandomState(8)
    cfg = loop_closure.LoopDetectorConfig(
        minimum_age_difference=1, minimum_matches=25, query_tile=4096)
    db = loop_closure.empty_database(262144)
    desc0 = _random_desc(rng, 100)
    db = loop_closure.add_local_map(
        db, jnp.asarray(desc0),
        jnp.asarray(rng.uniform(-5, 5, (100, 3)).astype(np.float32)),
        jnp.ones(100, bool), 0,
    )
    db = loop_closure.add_local_map(
        db, jnp.asarray(_random_desc(rng, 80)),
        jnp.zeros((80, 3), jnp.float32), jnp.ones(80, bool), 1,
    )
    q_desc = _flip_bits(rng, desc0, 5)
    res = loop_closure.query(
        jnp.asarray(q_desc), jnp.ones(100, bool), 5, db, cfg, num_maps=8
    )
    assert int(res.candidate_maps[0]) == 0
    assert int(res.votes[0]) >= 80
