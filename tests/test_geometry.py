"""Pinhole projection + triangulation round-trips.

Mirrors the synthetic fixture strategy of the reference tests
(tests/fixtures.hpp:91-421: pinhole K fx=450, 600x400, 250 px baseline)."""
import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.ops import pinhole, triangulation

CAM = pinhole.Camera(fx=450.0, fy=450.0, cx=300.0, cy=200.0, rows=400, cols=600,
                     baseline_px=250.0)


def sample_points(rng, n=100):
    """Random points in front of the camera, inside the frustum."""
    z = rng.uniform(2.0, 30.0, size=n)
    u = rng.uniform(20, CAM.cols - 20, size=n)
    v = rng.uniform(20, CAM.rows - 20, size=n)
    x = (u - CAM.cx) / CAM.fx * z
    y = (v - CAM.cy) / CAM.fy * z
    return jnp.asarray(np.stack([x, y, z], axis=1), dtype=jnp.float32)


def test_project_unproject_roundtrip(rng):
    pts = sample_points(rng)
    uv, in_view = pinhole.project(CAM, pts)
    assert bool(jnp.all(in_view))
    uvd = jnp.concatenate([uv, pts[:, 2:3]], axis=1)
    back, valid = pinhole.unproject(CAM, uvd)
    assert bool(jnp.all(valid))
    np.testing.assert_allclose(np.asarray(back), np.asarray(pts), rtol=1e-5, atol=1e-4)


def test_stereo_projection_disparity_positive(rng):
    pts = sample_points(rng)
    uvu, in_view = pinhole.project_stereo(CAM, pts)
    disparity = np.asarray(uvu[:, 0] - uvu[:, 2])
    assert np.all(disparity > 0)
    np.testing.assert_allclose(disparity, 250.0 / np.asarray(pts[:, 2]), rtol=1e-4)


def test_triangulation_roundtrip(rng):
    pts = sample_points(rng)
    uvu, _ = pinhole.project_stereo(CAM, pts)
    points4 = jnp.stack([uvu[:, 0], uvu[:, 1], uvu[:, 2], uvu[:, 1]], axis=1)
    tri, ok = triangulation.triangulate_rectified(
        CAM, points4, jnp.ones(pts.shape[0], bool), minimum_disparity_px=1.0)
    # points closer than baseline_px/1px disparity = 250 m are recoverable
    np.testing.assert_allclose(np.asarray(tri)[np.asarray(ok)],
                               np.asarray(pts)[np.asarray(ok)], rtol=1e-3, atol=1e-3)
    assert int(jnp.sum(ok)) == pts.shape[0]


def test_triangulation_rejects_low_disparity():
    points4 = jnp.array([[100.0, 50.0, 99.5, 50.0]])  # 0.5 px disparity
    tri, ok = triangulation.triangulate_rectified(
        CAM, points4, jnp.ones(1, bool), minimum_disparity_px=1.0)
    assert not bool(ok[0])
