"""Merger unit tests (reference tests/test_mergers.cpp parity).

The reference dedicates a test binary to the map-update core: descriptor
appearance gating, 2-D bin occupancy density control, target-merge gating of
additions, addition preference order, and the stereo-vs-RGB-D adaptation
paths (reference srrg2_proslam/tests/test_mergers.cpp, logic at
mapping/mergers/merger_projective_impl.cpp:72-308).  Here the merger is the
merge section of the fused tracker step (models/tracker.py track_step),
exercised through deterministic hand-built scenes.
"""
import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.models import landmarks as lm
from srrg2_proslam_jax.models.tracker import (
    MergerConfig, TrackerConfig, initial_state, track_step,
)
from srrg2_proslam_jax.ops.triangulation import triangulate_rectified
from srrg2_proslam_jax.ops.pinhole import unproject
from tests.test_slam import CAM

N = 64          # measurement capacity in these tests
CAP = 128       # arena capacity


def _desc(rng, n):
    return rng.choice(np.array([-1, 1], np.int8), size=(n, 256))


def _stereo_rows(pts_c):
    """Sensor-frame 3-D points -> (uL, v, uR, v) measurement rows."""
    z = pts_c[:, 2]
    u = CAM.fx * pts_c[:, 0] / z + CAM.cx
    v = CAM.fy * pts_c[:, 1] / z + CAM.cy
    ur = u - CAM.baseline_px / z
    return np.stack([u, v, ur, v], axis=1).astype(np.float32)


def _measurements(pts_c, desc, n_rows=N):
    rows = np.zeros((n_rows, 4), np.float32)
    d = np.full((n_rows, 256), -1, np.int8)
    ok = np.zeros(n_rows, bool)
    k = pts_c.shape[0]
    rows[:k] = _stereo_rows(pts_c)
    d[:k] = desc
    ok[:k] = True
    return jnp.asarray(rows), jnp.asarray(d), jnp.asarray(ok)


def _arena_with(pts_lm, desc, num_updates=3):
    arena = lm.empty_arena(CAP)
    k = pts_lm.shape[0]
    return arena._replace(
        pos=arena.pos.at[:k].set(jnp.asarray(pts_lm)),
        desc=arena.desc.at[:k].set(jnp.asarray(desc)),
        cov=arena.cov.at[:k].set(jnp.eye(3) * 0.05),
        num_updates=arena.num_updates.at[:k].set(num_updates),
        valid=arena.valid.at[:k].set(True),
    )


def _step(arena, rows, desc, ok, merger=None, tcfg=None):
    tcfg = tcfg or TrackerConfig(merger=merger or MergerConfig())
    state = initial_state(CAP)._replace(arena=arena)
    new_state, stats, _ = track_step(state, rows, desc, ok, CAM, tcfg,
                                     "stereo")
    return new_state, stats


def test_matched_landmarks_merge_not_insert(rng):
    """Re-observing existing landmarks updates them (no duplicates)."""
    pts = np.array([[0.0, 0.0, 10.0], [1.0, -0.5, 12.0], [-2.0, 1.0, 8.0]],
                   np.float32)
    desc = _desc(rng, 3)
    arena = _arena_with(pts, desc)
    rows, d, ok = _measurements(pts, desc)
    new_state, stats = _step(arena, rows, d, ok)
    assert int(stats.num_merges) == 3
    assert int(stats.num_additions) == 0
    assert int(new_state.arena.count) == 3
    # merged landmarks gain maturity (update counts increment)
    nu = np.asarray(new_state.arena.num_updates[:3])
    assert (nu == 4).all()


def test_appearance_gate_blocks_merge(rng):
    """maximum_distance_appearance rejects geometric matches with foreign
    descriptors (merger_projective_impl.cpp:72-75)."""
    pts = np.array([[0.0, 0.0, 10.0]], np.float32)
    desc = _desc(rng, 1)
    arena = _arena_with(pts, desc)
    # measurement at the same pixel but with ~128-bit-away descriptor
    far_desc = _desc(rng, 1)
    rows, d, ok = _measurements(pts, far_desc)
    merger = MergerConfig(maximum_distance_appearance=10.0)
    # loose matcher stage so the geometric match itself can happen
    _, stats = _step(arena, rows, d, ok, merger=merger)
    assert int(stats.num_merges) == 0


def test_target_number_of_merges_gates_additions(rng):
    """Additions only happen while merges < target (merger_projective_
    impl.cpp:193-308): a fully re-observed scene adds nothing even with
    unmatched candidates present."""
    pts = rng.uniform(-3, 3, (8, 3)).astype(np.float32) + [0, 0, 12]
    desc = _desc(rng, 8)
    arena = _arena_with(pts, desc)
    new_pts = rng.uniform(-3, 3, (8, 3)).astype(np.float32) + [0, 0, 20]
    all_pts = np.concatenate([pts, new_pts])
    all_desc = np.concatenate([desc, _desc(rng, 8)])
    rows, d, ok = _measurements(all_pts, all_desc)
    # target below the number of merges -> additions suppressed
    _, stats_low = _step(arena, rows, d, ok,
                         merger=MergerConfig(target_number_of_merges=4,
                                             enable_binning=False))
    assert int(stats_low.num_merges) >= 4
    assert int(stats_low.num_additions) == 0
    # target above -> the unmatched candidates insert
    _, stats_high = _step(arena, rows, d, ok,
                          merger=MergerConfig(target_number_of_merges=100,
                                              enable_binning=False))
    assert int(stats_high.num_additions) == 8


def test_binning_occupancy_and_preference(rng):
    """Bin density control (merger_projective_impl.cpp:90-124): only the
    best candidate per bin inserts, and bins already occupied by projected
    landmarks accept nothing."""
    merger = MergerConfig(bin_size_px=50, enable_binning=True)
    # two candidates in the SAME bin at different depths: the higher
    # disparity (nearer) one wins (merger_projective_rigid_stereo_impl.
    # cpp:44-56)
    near = np.array([[0.2, 0.15, 8.0]], np.float32)     # -> px (311, 208)
    far = np.array([[0.8, 0.6, 30.0]], np.float32)      # -> px (312, 209)
    desc2 = _desc(rng, 2)
    rows, d, ok = _measurements(np.concatenate([near, far]), desc2)
    new_state, stats = _step(lm.empty_arena(CAP), rows, d, ok, merger=merger)
    assert int(stats.num_additions) == 1
    inserted = np.asarray(new_state.arena.pos[np.asarray(
        new_state.arena.valid)])
    assert abs(inserted[0, 2] - 8.0) < 0.5  # the near candidate
    # a candidate projecting into a bin occupied by an existing landmark
    # is rejected
    occupant = np.array([[0.1, 0.1, 10.0]], np.float32)   # -> px (304, 204)
    arena = _arena_with(occupant, _desc(rng, 1))
    cand = np.array([[0.4, 0.3, 15.0]], np.float32)       # -> px (312, 209)
    rows, d, ok = _measurements(cand, _desc(rng, 1))
    _, stats = _step(arena, rows, d, ok, merger=merger)
    assert int(stats.num_additions) == 0


def test_stereo_adaptation_triangulates(rng):
    """Stereo insertion reproduces the rectified-midpoint triangulation
    (triangulator_rigid_stereo.cpp:59-85)."""
    pts = np.array([[1.5, -0.8, 14.0], [-2.0, 0.3, 7.0]], np.float32)
    rows, d, ok = _measurements(pts, _desc(rng, 2))
    new_state, stats = _step(lm.empty_arena(CAP), rows, d, ok,
                             merger=MergerConfig(enable_binning=False))
    assert int(stats.num_additions) == 2
    got = np.sort(np.asarray(
        new_state.arena.pos[np.asarray(new_state.arena.valid)]), axis=0)
    expect, okk = triangulate_rectified(CAM, rows[:2], ok[:2], 1.0)
    expect = np.sort(np.asarray(expect), axis=0)
    np.testing.assert_allclose(got, expect, atol=1e-3)


def test_rgbd_adaptation_unprojects(rng):
    """RGB-D insertion reproduces pinhole unprojection
    (merger_projective_depth_ekf_impl.cpp:55-73)."""
    pts = np.array([[1.0, -0.5, 9.0]], np.float32)
    z = pts[:, 2]
    u = CAM.fx * pts[:, 0] / z + CAM.cx
    v = CAM.fy * pts[:, 1] / z + CAM.cy
    rows = np.zeros((N, 3), np.float32)
    rows[0] = [u[0], v[0], z[0]]
    d = np.full((N, 256), -1, np.int8)
    d[0] = _desc(rng, 1)
    ok = np.zeros(N, bool)
    ok[0] = True
    tcfg = TrackerConfig(merger=MergerConfig(enable_binning=False))
    state = initial_state(CAP)
    new_state, stats, _ = track_step(
        state, jnp.asarray(rows), jnp.asarray(d), jnp.asarray(ok), CAM,
        tcfg, "rgbd")
    assert int(stats.num_additions) == 1
    got = np.asarray(new_state.arena.pos[np.asarray(new_state.arena.valid)])
    expect, _ = unproject(CAM, jnp.asarray(rows[:1]))
    np.testing.assert_allclose(got[0], np.asarray(expect)[0], atol=1e-4)
