"""Weighted-mean and pose-based-smoother landmark estimator tests.

Mirrors the reference estimator tests' synthetic methodology (noise-free
must be near-exact, noisy must beat measurement noise — reference
srrg2_proslam/tests/test_projective_point_ekf.cpp style via the Synthetic
fixture, fixtures.hpp:91-421).
"""
import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.ops import se3
from srrg2_proslam_jax.ops.landmark_estimators import (
    MeasurementBuffer,
    SmootherConfig,
    WeightedMeanConfig,
    add_measurements,
    empty_measurement_buffer,
    smoother_update_batch,
    weighted_mean_update_batch,
)
from srrg2_proslam_jax.ops.pinhole import Camera


CAM = Camera(fx=450.0, fy=450.0, cx=300.0, cy=200.0, rows=400, cols=600,
             baseline_px=450.0 * 0.5)


def test_weighted_mean_converges_to_measurements():
    cfg = WeightedMeanConfig()
    pos = jnp.asarray([[1.0, 2.0, 3.0]], jnp.float32)
    target = jnp.asarray([[1.5, 2.0, 3.0]], jnp.float32)
    n = jnp.zeros((1,), jnp.int32)
    for _ in range(50):
        out = weighted_mean_update_batch(pos, n, target, jnp.ones(1, bool), cfg)
        assert bool(out.accepted[0])
        pos = out.position
        n = n + 1
    np.testing.assert_allclose(np.asarray(pos[0]), np.asarray(target[0]), atol=0.05)


def test_weighted_mean_geometry_gate():
    cfg = WeightedMeanConfig(maximum_distance_geometry_m2=0.01)
    pos = jnp.zeros((1, 3), jnp.float32)
    far = jnp.asarray([[100.0, 0.0, 0.0]], jnp.float32)
    out = weighted_mean_update_batch(pos, jnp.zeros((1,), jnp.int32), far,
                                     jnp.ones(1, bool), cfg)
    assert not bool(out.accepted[0])
    np.testing.assert_array_equal(np.asarray(out.position), np.asarray(pos))


def _observe(p_world, T_wc):
    """Project a world point through world->camera transform T_wc."""
    p_c = T_wc[:3, :3] @ p_world + T_wc[:3, 3]
    u = CAM.fx * p_c[0] / p_c[2] + CAM.cx
    v = CAM.fy * p_c[1] / p_c[2] + CAM.cy
    return np.array([u, v]), p_c


def test_smoother_recovers_point_from_multiple_views(rng):
    gt = np.array([0.5, -0.3, 8.0], np.float32)
    M, K = 4, 8
    buf = empty_measurement_buffer(M, K)
    positions = jnp.asarray(np.tile(gt + [0.3, -0.2, 0.8], (M, 1)), jnp.float32)
    # 5 camera poses looking at the point from different spots
    for k in range(5):
        xi = np.zeros(6, np.float32)
        xi[0] = 0.4 * k  # sideways baseline
        xi[4] = 0.02 * k
        T_cw = np.asarray(se3.exp(jnp.asarray(xi)))  # world -> camera
        uv, p_c = _observe(gt, T_cw)
        uv_n = uv + rng.normal(0, 0.2, 2)
        buf = add_measurements(
            buf,
            jnp.asarray(np.tile(uv_n, (M, 1)), jnp.float32),
            jnp.asarray(np.tile(p_c, (M, 1)), jnp.float32),
            jnp.asarray(T_cw, jnp.float32),
            jnp.ones(M, bool),
        )
    out = smoother_update_batch(
        positions, buf, jnp.zeros(M, jnp.int32), jnp.ones(M, bool),
        CAM, SmootherConfig(),
    )
    assert bool(out.accepted[0])
    err = np.linalg.norm(np.asarray(out.position[0]) - gt)
    err0 = np.linalg.norm(np.asarray(positions[0]) - gt)
    assert err < 0.1, err          # recovered within 10 cm
    assert err < 0.2 * err0        # big improvement over the bad prior


def test_smoother_mean_fallback_below_minimum():
    gt = np.array([0.0, 0.0, 5.0], np.float32)
    buf = empty_measurement_buffer(1, 8)
    # only two measurements -> mean fallback (minimum is 3)
    for k in range(2):
        xi = np.zeros(6, np.float32)
        xi[0] = 0.3 * k
        T_cw = np.asarray(se3.exp(jnp.asarray(xi)))
        uv, p_c = _observe(gt, T_cw)
        buf = add_measurements(
            buf, jnp.asarray(uv[None], jnp.float32),
            jnp.asarray(p_c[None], jnp.float32),
            jnp.asarray(T_cw, jnp.float32), jnp.ones(1, bool),
        )
    pos0 = jnp.asarray(gt[None] + np.array([[1.0, 1.0, 1.0]], np.float32))
    out = smoother_update_batch(
        pos0, buf, jnp.zeros(1, jnp.int32), jnp.ones(1, bool),
        CAM, SmootherConfig(minimum_measurements=3),
    )
    # mean of unprojected camera points equals the GT world point exactly
    np.testing.assert_allclose(np.asarray(out.position[0]), gt, atol=1e-4)


def test_measurement_buffer_ring_wraps():
    buf = empty_measurement_buffer(2, 3)
    for k in range(5):
        buf = add_measurements(
            buf,
            jnp.full((2, 2), float(k), jnp.float32),
            jnp.full((2, 3), float(k), jnp.float32),
            jnp.eye(4, dtype=jnp.float32),
            jnp.asarray([True, k % 2 == 0]),
        )
    assert int(buf.count[0]) == 5
    assert int(buf.count[1]) == 3
    # ring: landmark 0 slots hold measurements {3, 4, 2} in ring order
    vals = sorted(float(v) for v in np.asarray(buf.point_in_image[0, :, 0]))
    assert vals == [2.0, 3.0, 4.0]
