"""Fused Pallas GN burst == XLA gn_iterate on the stereo factor.

The kernel (ops/gn_pallas.py) must converge to the same pose and report
the same inlier statistics as the reference-parity XLA path
(ops/gn.py::gn_iterate over stereo_projective_system) — reduction order
differs, so the bound is a tight float tolerance, not bit equality.
Runs in interpreter mode on CPU; chip_smoke.py checks the compiled
kernel on the GPU at the tracker's widths.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from srrg2_proslam_jax.ops import gn, se3
from srrg2_proslam_jax.ops.gn_pallas import gn_burst_stereo
from srrg2_proslam_jax.ops.pinhole import Camera

CAM = Camera(fx=450.0, fy=450.0, cx=320.0, cy=240.0, rows=480, cols=640,
             baseline_px=45.0)


def _problem(rng, n=300, outliers=0, n_valid=None):
    pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    pts[:, 2] += 8.0
    X_gt = se3.exp(jnp.asarray(
        np.array([0.2, -0.1, 0.35, 0.02, -0.01, 0.03], np.float32)))
    p = se3.transform_points(X_gt, jnp.asarray(pts))
    meas = jnp.stack([
        CAM.fx * p[:, 0] / p[:, 2] + CAM.cx,
        CAM.fy * p[:, 1] / p[:, 2] + CAM.cy,
        CAM.fx * p[:, 0] / p[:, 2] + CAM.cx - CAM.baseline_px / p[:, 2],
    ], -1)
    if outliers:
        noise = rng.uniform(50, 200, (outliers, 3)).astype(np.float32)
        meas = meas.at[:outliers].add(jnp.asarray(noise))
    w = jnp.asarray(rng.uniform(0.5, 2.0, (n,)).astype(np.float32))
    mask = (jnp.arange(n) < (n_valid if n_valid is not None else n))
    return jnp.asarray(pts), meas, w, mask, X_gt


@pytest.mark.parametrize("eps,outliers,n_valid", [
    (0.0, 0, None),
    (1e-5, 30, None),
    (0.0, 0, 4),     # below min_inliers: estimate must freeze
])
def test_pallas_burst_matches_xla(rng, eps, outliers, n_valid):
    pts, meas, w, mask, _ = _problem(rng, outliers=outliers,
                                     n_valid=n_valid)
    system = lambda X: gn.stereo_projective_system(
        X, pts, meas, w, mask, CAM, 25.0)
    X_ref, s_ref = gn.gn_iterate(system, se3.identity(), 5,
                                 damping=1e-6, min_inliers=6, epsilon=eps,
                                 unroll=True)
    X_k, s_k = gn_burst_stereo(se3.identity(), pts, meas, w, mask, CAM,
                               iterations=5, damping=1e-6, min_inliers=6,
                               epsilon=eps, chi_threshold=25.0,
                               interpret=True)
    np.testing.assert_allclose(np.asarray(X_k), np.asarray(X_ref),
                               atol=5e-4)
    assert int(s_k.num_terms) == int(s_ref.num_terms)
    assert abs(int(s_k.num_inliers) - int(s_ref.num_inliers)) <= 1
    np.testing.assert_allclose(float(s_k.chi_total),
                               float(s_ref.chi_total), rtol=1e-2,
                               atol=1e-2)


def test_pallas_burst_converges_to_gt(rng):
    pts, meas, w, mask, X_gt = _problem(rng)
    X_k, s_k = gn_burst_stereo(se3.identity(), pts, meas, w, mask, CAM,
                               iterations=10, interpret=True)
    t_err, ang = se3.error_t_and_angle(X_k, X_gt)
    assert float(jnp.max(jnp.abs(t_err))) < 1e-3
    assert float(ang) < 1e-4
    assert int(s_k.num_inliers) == pts.shape[0]


def test_pallas_burst_heavy_weights(rng):
    """Information weights ~1e8 push H's entries past 1e13: the
    Jacobi-scaled Cholesky still solves the system like the XLA path."""
    pts, meas, w, mask, X_gt = _problem(rng)
    w = w * 1e8
    system = lambda X: gn.stereo_projective_system(
        X, pts, meas, w, mask, CAM, 25.0)
    X_ref, _ = gn.gn_iterate(system, se3.identity(), 5)
    X_k, s_k = gn_burst_stereo(se3.identity(), pts, meas, w, mask, CAM,
                               iterations=5, interpret=True)
    assert np.all(np.isfinite(np.asarray(X_k)))
    np.testing.assert_allclose(np.asarray(X_k), np.asarray(X_ref),
                               atol=5e-4)
    t_err, _ = se3.error_t_and_angle(X_k, X_gt)
    assert float(jnp.max(jnp.abs(t_err))) < 1e-3
