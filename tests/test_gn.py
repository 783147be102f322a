"""GN pose alignment on synthetic worlds (reference tests/test_aligners.cpp
strategy: random world points + GT transform, assert manifold error)."""
import numpy as np
import jax
import jax.numpy as jnp

from srrg2_proslam_jax.ops import gn, pinhole, se3

CAM = pinhole.Camera(fx=450.0, fy=450.0, cx=300.0, cy=200.0, rows=400, cols=600,
                     baseline_px=250.0)


def world_and_pose(rng, n=200, t_mag=0.3, w_mag=0.05):
    z = rng.uniform(3.0, 30.0, size=n)
    u = rng.uniform(50, CAM.cols - 50, size=n)
    v = rng.uniform(50, CAM.rows - 50, size=n)
    pts = np.stack([(u - CAM.cx) / CAM.fx * z, (v - CAM.cy) / CAM.fy * z, z], 1)
    xi = np.concatenate([rng.randn(3) * t_mag, rng.randn(3) * w_mag])
    X_gt = se3.exp(jnp.asarray(xi, dtype=jnp.float32))
    return jnp.asarray(pts, dtype=jnp.float32), X_gt


def assert_pose_close(X, X_gt, t_tol=5e-3, r_tol=1e-3):
    t_err, angle = se3.error_t_and_angle(X, X_gt)
    assert float(jnp.max(t_err)) < t_tol, (np.asarray(t_err), float(angle))
    assert float(angle) < r_tol


def test_stereo_projective_alignment(rng):
    pts, X_gt = world_and_pose(rng)
    p_cam = se3.transform_points(X_gt, pts)
    meas, in_view = pinhole.project_stereo(CAM, p_cam)
    weights = jnp.ones(pts.shape[0])

    def system(X):
        return gn.stereo_projective_system(X, pts, meas, weights, in_view, CAM)

    X, stats = gn.gn_iterate(system, se3.identity(), iterations=10)
    assert int(stats.num_inliers) > 100
    assert_pose_close(X, X_gt)


def test_stereo_alignment_with_outliers(rng):
    pts, X_gt = world_and_pose(rng)
    p_cam = se3.transform_points(X_gt, pts)
    meas, in_view = pinhole.project_stereo(CAM, p_cam)
    # corrupt 20% of measurements by 100 px — robust kernel must reject them
    n = pts.shape[0]
    bad = jnp.asarray(rng.rand(n) < 0.2)
    meas = jnp.where(bad[:, None], meas + 100.0, meas)
    weights = jnp.ones(n)

    def system(X):
        return gn.stereo_projective_system(X, pts, meas, weights, in_view, CAM)

    X, stats = gn.gn_iterate(system, se3.identity(), iterations=15)
    assert_pose_close(X, X_gt, t_tol=2e-2, r_tol=3e-3)


def test_projective_depth_alignment(rng):
    pts, X_gt = world_and_pose(rng)
    p_cam = se3.transform_points(X_gt, pts)
    uv, in_view = pinhole.project(CAM, p_cam)
    meas = jnp.concatenate([uv, p_cam[:, 2:3]], axis=1)
    weights = jnp.ones(pts.shape[0])

    def system(X):
        return gn.projective_depth_system(X, pts, meas, weights, in_view, CAM)

    X, stats = gn.gn_iterate(system, se3.identity(), iterations=10)
    assert_pose_close(X, X_gt)


def test_point3_alignment(rng):
    pts, X_gt = world_and_pose(rng, t_mag=1.0, w_mag=0.2)
    fixed = se3.transform_points(X_gt, pts)
    weights = jnp.ones(pts.shape[0])
    mask = jnp.ones(pts.shape[0], bool)

    def system(X):
        return gn.point3_system(X, pts, fixed, weights, mask, chi_threshold=3.0)

    X, stats = gn.gn_iterate(system, se3.identity(), iterations=10)
    assert_pose_close(X, X_gt, t_tol=1e-2, r_tol=2e-3)
    assert int(stats.num_inliers) == pts.shape[0]


def test_min_inliers_freezes_estimate(rng):
    pts, X_gt = world_and_pose(rng, n=8)
    p_cam = se3.transform_points(X_gt, pts)
    meas, _ = pinhole.project_stereo(CAM, p_cam)
    mask = jnp.arange(8) < 3  # below min_inliers=6
    weights = jnp.ones(8)

    def system(X):
        return gn.stereo_projective_system(X, pts, meas, weights, mask, CAM)

    X, _ = gn.gn_iterate(system, se3.identity(), iterations=5, min_inliers=6)
    np.testing.assert_allclose(np.asarray(X), np.eye(4), atol=1e-6)


def test_full_pipeline_jits(rng):
    """The aligner loop compiles as a single jit without host sync."""
    pts, X_gt = world_and_pose(rng)
    p_cam = se3.transform_points(X_gt, pts)
    meas, in_view = pinhole.project_stereo(CAM, p_cam)

    @jax.jit
    def run(meas):
        def system(X):
            return gn.stereo_projective_system(
                X, pts, meas, jnp.ones(pts.shape[0]), in_view, CAM)
        return gn.gn_iterate(system, se3.identity(), iterations=10)

    X, stats = run(meas)
    assert_pose_close(X, X_gt)


def test_gn_epsilon_termination_matches_fixed_count(rng):
    """SimpleTerminationCriteria analog (kitti.conf:593-615): a positive
    epsilon must converge to the same pose as the fixed-count loop (within
    the step bound) — it only stops paying for no-op iterations."""
    import numpy as np
    import jax.numpy as jnp
    from srrg2_proslam_jax.ops import se3
    from srrg2_proslam_jax.ops.gn import gn_iterate, point3_system

    pts = jnp.asarray(rng.uniform(-5, 5, (200, 3)).astype(np.float32))
    T_gt = se3.exp(jnp.asarray(
        np.array([0.3, -0.1, 0.5, 0.02, -0.03, 0.04], np.float32)))
    fixed = se3.transform_points(T_gt, pts)
    w = jnp.ones(200)
    m = jnp.ones(200, bool)
    system = lambda X: point3_system(X, pts, fixed, w, m, chi_threshold=9.0)
    X_fixed, s1 = gn_iterate(system, jnp.eye(4), 30, epsilon=0.0)
    X_eps, s2 = gn_iterate(system, jnp.eye(4), 30, epsilon=1e-6)
    t_err, ang = se3.error_t_and_angle(X_eps, X_fixed)
    assert float(jnp.max(t_err)) < 1e-4
    assert float(ang) < 1e-5
    assert int(s2.num_inliers) == int(s1.num_inliers)


def test_gn_unrolled_matches_while_loop(rng):
    """``unroll=True`` is an execution-scheme switch, not a semantic one:
    the sticky-stop unrolled chain must return bit-identical (X, stats) to
    the bounded while_loop for epsilon 0 and positive, including the
    degenerate min_inliers freeze."""
    import numpy as np
    import jax.numpy as jnp
    from srrg2_proslam_jax.ops import se3
    from srrg2_proslam_jax.ops.gn import gn_iterate, point3_system

    pts = jnp.asarray(rng.uniform(-5, 5, (100, 3)).astype(np.float32))
    T_gt = se3.exp(jnp.asarray(
        np.array([0.2, 0.1, -0.4, 0.03, 0.02, -0.05], np.float32)))
    fixed = se3.transform_points(T_gt, pts)
    w = jnp.ones(100)
    for n_valid, eps in ((100, 0.0), (100, 1e-5), (3, 0.0)):
        m = jnp.arange(100) < n_valid
        system = lambda X: point3_system(X, pts, fixed, w, m,
                                         chi_threshold=9.0)
        X_l, s_l = gn_iterate(system, jnp.eye(4), 12, epsilon=eps)
        X_u, s_u = gn_iterate(system, jnp.eye(4), 12, epsilon=eps,
                              unroll=True)
        np.testing.assert_array_equal(np.asarray(X_l), np.asarray(X_u))
        assert int(s_l.num_inliers) == int(s_u.num_inliers)
        np.testing.assert_array_equal(np.asarray(s_l.chi_total),
                                      np.asarray(s_u.chi_total))
