"""Sensor-in-robot extrinsics + constant-velocity motion prior.

The reference threads a TF-platform extrinsic through its projector/clipper/
triangulator and the WithSensor factor variants (reference srrg2_proslam/src/
srrg2_proslam/registration/aligner_slice_processor_projective.h:63-192,
configurations/kitti_in_baselink.conf), and wires a constant-velocity prior
factor into the multi-cue solve (AlignerSliceMotionModel3D,
configurations/kitti.conf:747-772).  These tests pin both capabilities.
"""
import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.models import landmarks as lm
from srrg2_proslam_jax.models.slam import GraphSLAM, GraphSLAMConfig, SplittingConfig
from srrg2_proslam_jax.models.tracker import (
    TrackerConfig, initial_state, track_step,
)
from srrg2_proslam_jax.ops import se3
from tests.test_slam import CAM, _world


def _project_stereo_from(pts_w, desc, T_wc):
    """Measurements as seen by a camera with world->camera transform T_wc."""
    p_c = pts_w @ T_wc[:3, :3].T + T_wc[:3, 3]
    z = p_c[:, 2]
    ok = z > 0.5
    zs = np.maximum(z, 0.5)
    u = CAM.fx * p_c[:, 0] / zs + CAM.cx
    v = CAM.fy * p_c[:, 1] / zs + CAM.cy
    ur = u - CAM.baseline_px / zs
    ok &= (u >= 0) & (u < CAM.cols) & (v >= 0) & (v < CAM.rows) & (ur >= 0)
    pts = np.stack([u, v, ur, v], axis=1).astype(np.float32)
    return jnp.asarray(pts), jnp.asarray(desc), jnp.asarray(ok)


def test_vo_with_sensor_extrinsic(rng):
    """5-frame VO with a non-identity camera-in-robot offset must recover
    the ROBOT trajectory within the reference tracker bounds
    (test_trackers.cpp:359-364: <= (0.2, 0.2, 0.7) m, <= 0.01 rad)."""
    pts_w = _world(rng, n=400)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(400, 256))
    # camera mounted 0.3 m ahead, 0.1 m left, slightly yawed
    T_rs = np.asarray(se3.exp(jnp.asarray(
        np.array([-0.1, 0.05, 0.3, 0.0, 0.03, 0.0], np.float32))))
    config = GraphSLAMConfig(
        tracker=TrackerConfig(T_robot_sensor=tuple(T_rs.reshape(-1).tolist())),
        splitting=SplittingConfig(maximum_translation_m=100.0),
        arena_capacity=1024,
        enable_loop_closing=False,
    )
    slam = GraphSLAM(CAM, config)
    T_wr = np.eye(4, dtype=np.float32)  # robot in world
    gt_robot = []
    for i in range(6):
        T_wc = np.linalg.inv(T_wr @ T_rs).astype(np.float32)  # world->camera
        p, d, ok = _project_stereo_from(pts_w, desc, T_wc)
        slam.process(p, d, ok, timestamp=0.1 * i)
        gt_robot.append(T_wr.copy())
        step = np.asarray(se3.exp(jnp.asarray(
            np.array([0.0, 0.0, 0.35, 0.0, 0.02, 0.0], np.float32))))
        T_wr = (T_wr @ step).astype(np.float32)

    T_est = slam.robot_in_world()
    t_err = np.abs(T_est[:3, 3] - gt_robot[-1][:3, 3])
    assert np.all(t_err < np.array([0.2, 0.2, 0.7])), t_err
    dR = T_est[:3, :3].T @ gt_robot[-1][:3, :3]
    ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
    assert ang < 0.01, ang


def _arena_with(pts_lm, desc):
    state = initial_state(512)
    n = pts_lm.shape[0]
    arena = state.arena._replace(
        pos=state.arena.pos.at[:n].set(jnp.asarray(pts_lm)),
        desc=state.arena.desc.at[:n].set(jnp.asarray(desc)),
        cov=state.arena.cov.at[:n].set(jnp.eye(3) * 0.05),
        num_updates=state.arena.num_updates.at[:n].set(1),
        valid=state.arena.valid.at[:n].set(True),
    )
    return state._replace(arena=arena)


def test_motion_prior_bounds_low_support_step(rng):
    """With few, conflicting correspondences the prior must pull the
    estimate toward the constant-velocity prediction."""
    n = 12
    pts_lm = np.stack([
        rng.uniform(-8, 8, n), rng.uniform(-3, 3, n), rng.uniform(6, 25, n),
    ], 1).astype(np.float32)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(n, 256))
    # measurements claim the camera jumped 0.5 m sideways (inconsistent
    # with the zero-velocity prediction, inside the matcher search radius)
    T_jump = np.eye(4, dtype=np.float32)
    T_jump[0, 3] = 0.5
    T_wc = np.linalg.inv(T_jump).astype(np.float32)
    p_c = pts_lm @ T_wc[:3, :3].T + T_wc[:3, 3]
    u = CAM.fx * p_c[:, 0] / p_c[:, 2] + CAM.cx
    v = CAM.fy * p_c[:, 1] / p_c[:, 2] + CAM.cy
    ur = u - CAM.baseline_px / p_c[:, 2]
    meas = jnp.asarray(np.stack([u, v, ur, v], 1).astype(np.float32))
    valid = jnp.ones(n, bool)
    dpad = jnp.asarray(desc)

    def run(t_info):
        cfg_t = TrackerConfig(
            matcher=TrackerConfig().matcher,
            motion_prior_translation_info=t_info,
            motion_prior_rotation_info=t_info,
        )
        state = _arena_with(pts_lm, desc)
        # pad measurement rows to the arena-independent capacity n
        new_state, stats, X = track_step(
            state, meas, dpad, valid, CAM, cfg_t, "stereo"
        )
        return np.asarray(new_state.T_lm_robot)

    T_free = run(0.0)
    T_prior = run(1e5)
    # without the prior the estimate follows the 0.5 m jump; with a strong
    # prior it stays near the identity prediction
    assert abs(T_free[0, 3] - 0.5) < 0.1, T_free[0, 3]
    assert abs(T_prior[0, 3]) < 0.5 * abs(T_free[0, 3]), T_prior[0, 3]


def test_identity_extrinsic_matches_default(rng):
    """T_robot_sensor=identity must reproduce the default path bit-for-bit."""
    n = 64
    pts_lm = np.stack([
        rng.uniform(-8, 8, n), rng.uniform(-3, 3, n), rng.uniform(6, 25, n),
    ], 1).astype(np.float32)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(n, 256))
    p_c = pts_lm
    u = CAM.fx * p_c[:, 0] / p_c[:, 2] + CAM.cx
    v = CAM.fy * p_c[:, 1] / p_c[:, 2] + CAM.cy
    ur = u - CAM.baseline_px / p_c[:, 2]
    meas = jnp.asarray(np.stack([u, v, ur, v], 1).astype(np.float32))
    state = _arena_with(pts_lm, desc)
    out1, st1, _ = track_step(state, meas, jnp.asarray(desc),
                              jnp.ones(n, bool), CAM, TrackerConfig(), "stereo")
    out2, st2, _ = track_step(state, meas, jnp.asarray(desc),
                              jnp.ones(n, bool), CAM,
                              TrackerConfig(T_robot_sensor=tuple(
                                  np.eye(4, dtype=np.float32).reshape(-1).tolist())),
                              "stereo")
    np.testing.assert_array_equal(np.asarray(out1.T_lm_robot),
                                  np.asarray(out2.T_lm_robot))
