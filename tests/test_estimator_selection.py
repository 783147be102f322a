"""Config-selected landmark estimators both track the synthetic world."""
import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.models.tracker import TrackerConfig, initial_state, track_step
from tests.test_slam import CAM, _world, _stereo_measurements


def _run(tcfg, rng):
    pts_w = _world(rng)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(pts_w.shape[0], 256))
    state = initial_state(1024, estimator=tcfg.landmark_estimator)
    import srrg2_proslam_jax.ops.se3 as se3
    T_wc = np.eye(4, dtype=np.float32)
    last = None
    for i in range(5):
        p, d, ok = _stereo_measurements(pts_w, desc, T_wc)
        state, stats, X = track_step(state, p, d, ok, CAM, tcfg, "stereo")
        T_wc[2, 3] -= 0.3  # camera forward
        last = stats
    return state, last


def test_weighted_mean_estimator_tracks(rng):
    state, stats = _run(TrackerConfig(landmark_estimator="weighted_mean"), rng)
    assert int(stats.num_inliers) > 50
    assert int(stats.num_merges) > 30
    t = np.asarray(state.T_lm_robot)[:3, 3]
    np.testing.assert_allclose(t, [0, 0, 1.2], atol=0.05)


def test_ekf_estimator_tracks(rng):
    state, stats = _run(TrackerConfig(landmark_estimator="ekf"), rng)
    assert int(stats.num_inliers) > 50
    t = np.asarray(state.T_lm_robot)[:3, 3]
    np.testing.assert_allclose(t, [0, 0, 1.2], atol=0.05)


def test_smoother_estimator_tracks(rng):
    state, stats = _run(TrackerConfig(landmark_estimator="smoother"), rng)
    assert int(stats.num_inliers) > 50
    assert state.meas_buf is not None
    assert int(np.max(np.asarray(state.meas_buf.count))) >= 2
    t = np.asarray(state.T_lm_robot)[:3, 3]
    np.testing.assert_allclose(t, [0, 0, 1.2], atol=0.05)
