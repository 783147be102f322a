"""Landmark EKF tests mirroring the reference synthetic-noise protocol
(tests/test_projective_point_ekf.cpp:14-45: zero-noise must converge to the
true point; noisy measurements must beat the measurement noise)."""
import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.ops import ekf, pinhole, se3

CAM = pinhole.Camera(fx=450.0, fy=450.0, cx=300.0, cy=200.0, rows=400, cols=600,
                     baseline_px=250.0)
CFG = ekf.LandmarkEKFConfig(maximum_distance_geometry_m2=100.0,
                            maximum_covariance_norm_squared=1e6)


def measure(pts_cam, model):
    if model == "projective":
        uv, _ = pinhole.project(CAM, pts_cam)
        return uv
    if model == "projective_depth":
        uv, _ = pinhole.project(CAM, pts_cam)
        return jnp.concatenate([uv, pts_cam[:, 2:3]], axis=1)
    uvu, _ = pinhole.project_stereo(CAM, pts_cam)
    return jnp.concatenate([uvu, uvu[:, 1:2]], axis=1)  # (uL, vL, uR, vR=vL)


def run_filter(rng, model, noise_px, n_steps=20, n_landmarks=50):
    """Static landmarks observed from moving cameras; returns final errors."""
    z = rng.uniform(4.0, 15.0, n_landmarks)
    u = rng.uniform(100, 500, n_landmarks)
    v = rng.uniform(80, 320, n_landmarks)
    p_true = np.stack([(u - CAM.cx) / CAM.fx * z, (v - CAM.cy) / CAM.fy * z, z], 1)
    p_true = jnp.asarray(p_true, dtype=jnp.float32)

    # initial estimate: perturbed truth, large covariance
    p = p_true + jnp.asarray(rng.randn(n_landmarks, 3) * 0.5, dtype=jnp.float32)
    P = jnp.broadcast_to(jnp.eye(3) * 4.0, (n_landmarks, 3, 3))

    for step in range(n_steps):
        xi = np.concatenate([rng.randn(3) * 0.1, rng.randn(3) * 0.02])
        T_ws = se3.exp(jnp.asarray(xi, dtype=jnp.float32))  # world->sensor
        p_cam = se3.transform_points(T_ws, p_true)
        meas = measure(p_cam, model)
        meas = meas + jnp.asarray(
            rng.randn(*np.asarray(meas).shape) * noise_px, dtype=jnp.float32)
        result = ekf.ekf_update_batch(
            p, P, meas, jnp.ones(n_landmarks, bool), T_ws, CAM, model, CFG)
        p, P = result.position, result.covariance
    return np.linalg.norm(np.asarray(p - p_true), axis=1)


def test_stereo_ekf_noise_free(rng):
    err = run_filter(rng, "stereo", noise_px=0.0)
    assert np.median(err) < 0.02, np.median(err)


def test_stereo_ekf_noisy(rng):
    err = run_filter(rng, "stereo", noise_px=1.0)
    assert np.median(err) < 0.25, np.median(err)


def test_projective_depth_ekf_noise_free(rng):
    err = run_filter(rng, "projective_depth", noise_px=0.0)
    assert np.median(err) < 0.03, np.median(err)


def test_projective_ekf_reduces_error(rng):
    # bearing-only: depth weakly observable from small baprallax; error must
    # at least shrink vs the 0.5 m initial perturbation
    err = run_filter(rng, "projective", noise_px=0.0, n_steps=30)
    assert np.median(err) < 0.3, np.median(err)


def test_gates_reject_geometric_jumps(rng):
    p = jnp.asarray([[0.0, 0.0, 10.0]], dtype=jnp.float32)
    P = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32) * 4.0, (1, 3, 3))
    # measurement consistent with a point 30 m away -> >5 m jump, rejected
    cfg = ekf.LandmarkEKFConfig(maximum_distance_geometry_m2=25.0,
                                maximum_covariance_norm_squared=1e6)
    far = jnp.asarray([[0.0, 0.0, 40.0]], dtype=jnp.float32)
    meas = measure(far, "stereo")
    result = ekf.ekf_update_batch(p, P, meas, jnp.ones(1, bool),
                                  se3.identity(), CAM, "stereo", cfg)
    assert not bool(result.accepted[0])
    np.testing.assert_allclose(np.asarray(result.position), np.asarray(p))
