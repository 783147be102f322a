"""Scene-clipper unit tests (reference tests/test_scene_clippers.cpp parity).

The reference clipper projects the local map through the current estimate
and keeps in-frustum points (scene_clipper_projective_3d.cpp:46-66); the
redesign is an in-view mask over the full arena inside the fused tracker
step (models/tracker.py).  These tests pin the mask against a hand-computed
frustum: landmarks behind the camera, outside the image bounds, or out of
range must not match, and must not block bins.
"""
import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.models import landmarks as lm
from srrg2_proslam_jax.models.tracker import (
    MergerConfig, TrackerConfig, initial_state, track_step,
)
from srrg2_proslam_jax.ops.pinhole import project
from tests.test_merger import (
    CAP, N, _arena_with, _desc, _measurements, _step,
)
from tests.test_slam import CAM


def test_in_view_mask_matches_hand_frustum(rng):
    """project()'s in-view mask equals the analytic frustum check."""
    pts = np.concatenate([
        rng.uniform(-10, 10, (50, 3)).astype(np.float32) + [0, 0, 15],
        np.array([[0, 0, -5.0],            # behind the camera
                  [0, 0, 0.05],            # closer than range_min
                  [500.0, 0, 10.0],        # far outside the image
                  [0, 0, 1e6]],            # beyond range_max
                 np.float32),
    ])
    uv, in_view = project(CAM, jnp.asarray(pts))
    uv, in_view = np.asarray(uv), np.asarray(in_view)
    z = pts[:, 2]
    u = CAM.fx * pts[:, 0] / np.where(z > 0, z, 1.0) + CAM.cx
    v = CAM.fy * pts[:, 1] / np.where(z > 0, z, 1.0) + CAM.cy
    expect = ((z > CAM.range_min) & (z < CAM.range_max)
              & (u >= 0) & (u < CAM.cols) & (v >= 0) & (v < CAM.rows))
    np.testing.assert_array_equal(in_view, expect)
    assert not in_view[-4:].any()


def test_out_of_view_landmarks_do_not_match(rng):
    """A landmark behind the camera must not match a measurement even with
    an identical descriptor (the clipper's job in the reference)."""
    desc = _desc(rng, 1)
    behind = np.array([[0.0, 0.0, -10.0]], np.float32)
    arena = _arena_with(behind, desc)
    visible_meas = np.array([[0.0, 0.0, 10.0]], np.float32)
    rows, d, ok = _measurements(visible_meas, desc)
    _, stats = _step(arena, rows, d, ok)
    assert int(stats.num_matches) == 0
    assert int(stats.num_merges) == 0


def test_out_of_view_landmarks_do_not_occupy_bins(rng):
    """Bin occupancy (density control) only counts IN-VIEW landmarks: a
    behind-the-camera landmark must not block insertion anywhere."""
    behind = np.array([[0.0, 0.0, -10.0]], np.float32)
    arena = _arena_with(behind, _desc(rng, 1))
    cand = np.array([[0.1, 0.1, 10.0]], np.float32)
    rows, d, ok = _measurements(cand, _desc(rng, 1))
    _, stats = _step(arena, rows, d, ok,
                     merger=MergerConfig(bin_size_px=50))
    assert int(stats.num_additions) == 1


def test_landmark_reenters_view_and_matches(rng):
    """Clipping is a per-frame mask, not deletion: a landmark outside the
    current frustum stays in the arena and matches again once the robot
    pose brings it back into view."""
    desc = _desc(rng, 1)
    pt = np.array([[0.0, 0.0, 10.0]], np.float32)
    arena = _arena_with(pt, desc)
    rows, d, ok = _measurements(pt, desc)
    tcfg = TrackerConfig()
    # place the robot 1000 m past the landmark: it leaves the frustum
    state = initial_state(CAP)._replace(arena=arena)
    T_away = jnp.eye(4, dtype=jnp.float32).at[2, 3].set(1000.0)
    state = state._replace(T_lm_robot=T_away)
    _, stats_away, _ = track_step(state, rows, d, ok, CAM, tcfg, "stereo")
    assert int(stats_away.num_matches) == 0
    # back at the origin it matches again
    state = state._replace(T_lm_robot=jnp.eye(4, dtype=jnp.float32))
    _, stats_back, _ = track_step(state, rows, d, ok, CAM, tcfg, "stereo")
    assert int(stats_back.num_matches) == 1
