"""Sharded tracker step must match the single-device step."""
import numpy as np
import jax
import jax.numpy as jnp

from srrg2_proslam_jax import parallel
from srrg2_proslam_jax.io.datasets import kitti_camera
from srrg2_proslam_jax.models.tracker import TrackerConfig, initial_state, track_step


def _synthetic(rng, n_meas, capacity, cam):
    pts = np.stack([
        rng.uniform(-10, 10, n_meas),
        rng.uniform(-3, 3, n_meas),
        rng.uniform(4, 40, n_meas),
    ], axis=1).astype(np.float32)
    u = cam.fx * pts[:, 0] / pts[:, 2] + cam.cx
    v = cam.fy * pts[:, 1] / pts[:, 2] + cam.cy
    ur = u - cam.baseline_px / pts[:, 2]
    points = np.stack([u, v, ur, v], axis=1).astype(np.float32)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(n_meas, 256))
    valid = (u > 0) & (u < cam.cols) & (v > 0) & (v < cam.rows) & (ur > 0)
    state = initial_state(capacity)
    n_lm = min(n_meas, capacity)
    arena = state.arena._replace(
        pos=state.arena.pos.at[:n_lm].set(jnp.asarray(pts[:n_lm])),
        desc=state.arena.desc.at[:n_lm].set(jnp.asarray(desc[:n_lm])),
        cov=state.arena.cov.at[:n_lm].set(jnp.eye(3) * 0.05),
        num_updates=state.arena.num_updates.at[:n_lm].set(1),
        valid=state.arena.valid.at[:n_lm].set(True),
    )
    return state._replace(arena=arena), jnp.asarray(points), jnp.asarray(desc), jnp.asarray(valid)


def test_sharded_track_step_matches_single(rng):
    cam = kitti_camera()
    config = TrackerConfig()
    state, points, desc, valid = _synthetic(rng, 128, 256, cam)

    s1, stats1, X1 = track_step(state, points, desc, valid, cam, config, "stereo")
    mesh = parallel.make_mesh(jax.devices()[:8])
    s2, stats2, X2 = parallel.slam_step_spmd(
        mesh, state, points, desc, valid, cam, config, "stereo"
    )
    np.testing.assert_allclose(np.asarray(X1), np.asarray(X2), atol=1e-5)
    assert int(stats1.num_inliers) == int(stats2.num_inliers)
    assert int(stats1.num_matches) == int(stats2.num_matches)
    np.testing.assert_allclose(
        np.asarray(s1.arena.pos), np.asarray(s2.arena.pos), atol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(s1.arena.valid), np.asarray(s2.arena.valid)
    )
