"""Tracker idempotence: re-feeding the same frame must not move the robot
or grow the map (reference srrg2_proslam/tests/test_trackers.cpp:228-257;
drift tolerance adapted for the f32 EKF<->GN feedback per SURVEY.md §4.3)."""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from srrg2_proslam_jax.io import datasets
from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig, adapt_stereo
from srrg2_proslam_jax.models.tracker import TrackerConfig, initial_state, track_step

ROOT = os.path.join(os.path.dirname(__file__), "..", "test_data")


@pytest.mark.parametrize("estimator", ["ekf", "weighted_mean"])
def test_same_frame_is_idempotent(estimator):
    frames = list(datasets.iter_bundled_kitti(ROOT, "city"))
    cam = datasets.kitti_camera(*frames[0].left.shape)
    tcfg = TrackerConfig(landmark_estimator=estimator)
    meas = adapt_stereo(jnp.asarray(frames[0].left),
                        jnp.asarray(frames[0].right), StereoAdaptorConfig())
    state = initial_state(4096, estimator=estimator)
    sizes, drifts = [], []
    for _ in range(4):
        state, stats, X = track_step(
            state, meas.points, meas.desc, meas.valid, cam, tcfg, "stereo"
        )
        sizes.append(int(state.arena.count))
        drifts.append(float(jnp.linalg.norm(state.T_lm_robot[:3, 3])))
    # map must not grow after the initial population
    assert sizes[1:] == [sizes[0]] * 3, sizes
    # pose must stay put: reference-parity bound 1e-5
    # (test_trackers.cpp:252-256).  Requires the measurement model to be
    # exactly consistent with triangulation (epipolar-mean v, frontend.py);
    # with raw vL the gauge random-walks ~1 mm per re-feed.
    assert drifts[-1] < 1e-5, drifts
    # velocity must not wind up
    assert float(jnp.linalg.norm(state.velocity)) < 1e-3
