"""Bundle adjustment tests: synthetic multi-view recovery.

Methodology mirrors the reference's synthetic-world fixtures (noise-free
must be near-exact recovery; fixtures.hpp:91-421): generate a world, observe
it from several stereo poses, perturb poses+points, and require BA to pull
both back to ground truth.
"""
import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.ops import ba, se3
from srrg2_proslam_jax.ops.pinhole import Camera

CAM = Camera(fx=450.0, fy=450.0, cx=300.0, cy=200.0, rows=400, cols=600,
             baseline_px=450.0 * 0.5)


def _build_problem(rng, n_poses=4, n_points=60, noise=0.0):
    pts_w = np.stack([
        rng.uniform(-8, 8, n_points),
        rng.uniform(-3, 3, n_points),
        rng.uniform(5, 30, n_points),
    ], axis=1).astype(np.float32)
    gt_poses = []
    T = np.eye(4, dtype=np.float32)
    for k in range(n_poses):
        gt_poses.append(T.copy())
        step = np.asarray(se3.exp(jnp.asarray(
            np.array([0.3, 0.05, 0.5, 0.0, 0.02, 0.0], np.float32))))
        T = T @ step
    n_obs = n_poses * n_points
    problem = ba.empty_problem(n_poses, n_points, n_obs)
    obs_kf, obs_lm, obs_z, obs_valid = [], [], [], []
    for k, T_wk in enumerate(gt_poses):
        T_cw = np.linalg.inv(T_wk)
        p_c = pts_w @ T_cw[:3, :3].T + T_cw[:3, 3]
        z = np.maximum(p_c[:, 2], 1e-3)
        u = CAM.fx * p_c[:, 0] / z + CAM.cx
        v = CAM.fy * p_c[:, 1] / z + CAM.cy
        ur = u - CAM.baseline_px / z
        meas = np.stack([u, v, ur], axis=1)
        if noise:
            meas += rng.normal(0, noise, meas.shape)
        ok = (p_c[:, 2] > 1) & (u >= 0) & (u < CAM.cols) & (v >= 0) & (v < CAM.rows)
        obs_kf.append(np.full(n_points, k, np.int32))
        obs_lm.append(np.arange(n_points, dtype=np.int32))
        obs_z.append(meas.astype(np.float32))
        obs_valid.append(ok)
    problem = problem._replace(
        poses=jnp.asarray(np.stack(gt_poses)),
        pose_valid=jnp.ones(n_poses, bool),
        points=jnp.asarray(pts_w),
        point_valid=jnp.ones(n_points, bool),
        obs_kf=jnp.asarray(np.concatenate(obs_kf)),
        obs_lm=jnp.asarray(np.concatenate(obs_lm)),
        obs_z=jnp.asarray(np.concatenate(obs_z)),
        obs_valid=jnp.asarray(np.concatenate(obs_valid)),
    )
    return problem, np.stack(gt_poses), pts_w


def test_ba_noise_free_stays_at_gt(rng):
    problem, gt_poses, gt_pts = _build_problem(rng)
    out, chi = ba.optimize(problem, CAM, "stereo", ba.BAConfig(iterations=3))
    assert float(chi) < 1e-2
    np.testing.assert_allclose(np.asarray(out.poses), gt_poses, atol=2e-3)
    np.testing.assert_allclose(np.asarray(out.points), gt_pts, atol=2e-2)


def test_ba_recovers_perturbed_state(rng):
    problem, gt_poses, gt_pts = _build_problem(rng)
    # perturb all poses but the anchored first one, and all points
    poses = np.asarray(problem.poses).copy()
    for k in range(1, poses.shape[0]):
        xi = rng.normal(0, 0.03, 6).astype(np.float32)
        poses[k] = poses[k] @ np.asarray(se3.exp(jnp.asarray(xi)))
    pts = np.asarray(problem.points) + rng.normal(0, 0.3, gt_pts.shape).astype(np.float32)
    problem = problem._replace(poses=jnp.asarray(poses), points=jnp.asarray(pts))

    out, chi = ba.optimize(problem, CAM, "stereo", ba.BAConfig(iterations=8, structure_only=False))
    for k in range(poses.shape[0]):
        t_err, ang = se3.error_t_and_angle(out.poses[k], jnp.asarray(gt_poses[k]))
        assert float(jnp.max(t_err)) < 2e-2, (k, np.asarray(t_err))
        assert float(ang) < 2e-3
    err_pts = np.linalg.norm(np.asarray(out.points) - gt_pts, axis=1)
    assert np.median(err_pts) < 0.05


def test_ba_noisy_measurements_reduce_chi_and_pose_error(rng):
    """With pixel noise the BA optimum can't beat triangulation uncertainty
    on far points, so the guarantees tested are the real ones: reprojection
    chi drops to the noise floor and POSES (which average over all points)
    recover much better than the perturbation."""
    problem, gt_poses, gt_pts = _build_problem(rng, noise=0.5)
    poses = np.asarray(problem.poses).copy()
    for k in range(1, poses.shape[0]):
        xi = rng.normal(0, 0.02, 6).astype(np.float32)
        poses[k] = poses[k] @ np.asarray(se3.exp(jnp.asarray(xi)))
    pts0 = np.asarray(problem.points) + rng.normal(0, 0.2, gt_pts.shape).astype(np.float32)
    perturbed = problem._replace(poses=jnp.asarray(poses), points=jnp.asarray(pts0))
    # chi is evaluated before each update, so one iteration reports the
    # perturbed state's chi
    _, chi0 = ba.optimize(perturbed, CAM, "stereo", ba.BAConfig(iterations=1, structure_only=False))
    out, chi = ba.optimize(perturbed, CAM, "stereo", ba.BAConfig(iterations=8, structure_only=False))
    assert float(chi) < 0.2 * float(chi0), (float(chi0), float(chi))
    for k in range(1, poses.shape[0]):
        t_err_0, _ = se3.error_t_and_angle(jnp.asarray(poses[k]),
                                           jnp.asarray(gt_poses[k]))
        t_err, ang = se3.error_t_and_angle(out.poses[k], jnp.asarray(gt_poses[k]))
        assert float(jnp.max(t_err)) < 0.05
        assert float(ang) < 0.01


def test_ba_sharded_matches_single_device(rng):
    import jax
    from srrg2_proslam_jax import parallel

    problem, gt_poses, gt_pts = _build_problem(rng, n_poses=4, n_points=64)
    poses = np.asarray(problem.poses).copy()
    for k in range(1, poses.shape[0]):
        xi = rng.normal(0, 0.02, 6).astype(np.float32)
        poses[k] = poses[k] @ np.asarray(se3.exp(jnp.asarray(xi)))
    problem = problem._replace(poses=jnp.asarray(poses))
    config = ba.BAConfig(iterations=4, structure_only=False)
    out1, chi1 = ba.optimize(problem, CAM, "stereo", config)
    mesh = parallel.make_mesh(jax.devices()[:8])
    out2, chi2 = parallel.ba_optimize_spmd(mesh, problem, CAM, "stereo", config)
    np.testing.assert_allclose(np.asarray(out1.poses), np.asarray(out2.poses),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(out1.points), np.asarray(out2.points),
                               atol=1e-3)
