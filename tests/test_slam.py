"""GraphSLAM orchestrator tests on synthetic measurement streams.

Drives the full local-map/splitting/PGO machinery without image I/O by
synthesizing stereo measurements from a known world (the reference's
synthetic-fixture methodology, srrg2_proslam/tests/fixtures.hpp:91-421),
checking local-map splitting, graph growth, and trajectory consistency.
"""
import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.io.datasets import kitti_camera
from srrg2_proslam_jax.models.slam import (
    GraphSLAM, GraphSLAMConfig, SplittingConfig, TRACKING,
)
from srrg2_proslam_jax.models.tracker import TrackerConfig
from srrg2_proslam_jax.ops import se3

CAM = kitti_camera(rows=400, cols=600)._replace(fx=450.0, fy=450.0,
                                                cx=300.0, cy=200.0,
                                                baseline_px=450.0 * 0.5)


def _world(rng, n=400):
    return np.stack([
        rng.uniform(-15, 15, n),
        rng.uniform(-5, 5, n),
        rng.uniform(2, 40, n),
    ], axis=1).astype(np.float32)


def _stereo_measurements(pts_w, desc, T_wc):
    """Project world points into the stereo rig at world->camera T_wc."""
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


def _synthetic_run(n_frames=12, step_z=0.4, split_m=2.0, rng=None,
                   config=None):
    pts_w = _world(rng)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(pts_w.shape[0], 256))
    config = config or GraphSLAMConfig(
        tracker=TrackerConfig(),
        splitting=SplittingConfig(maximum_translation_m=split_m),
        arena_capacity=1024,
        enable_loop_closing=False,
    )
    slam = GraphSLAM(CAM, config)
    gt = []
    T_wc = np.eye(4, dtype=np.float32)  # world -> camera
    for i in range(n_frames):
        p, d, ok = _stereo_measurements(pts_w, desc, T_wc)
        slam.process(p, d, ok, timestamp=0.1 * i)
        gt.append(np.linalg.inv(T_wc))  # camera in world
        # advance camera forward along +z
        T_step = np.asarray(se3.exp(jnp.asarray(
            np.array([0, 0, -step_z, 0, 0, 0], np.float32))))
        T_wc = T_step @ T_wc
    return slam, gt


def test_slam_tracks_and_splits(rng):
    slam, gt = _synthetic_run(n_frames=12, step_z=0.4, split_m=2.0, rng=rng)
    assert slam.status == TRACKING
    # 12 frames x 0.4 m = 4.4 m of travel with 2 m splits -> >= 2 local maps
    assert slam.num_maps >= 2
    assert slam.num_edges == slam.num_maps - 1
    traj = slam.trajectory()
    assert len(traj) == 12
    final_err = np.linalg.norm(traj[-1][:3, 3] - gt[-1][:3, 3])
    assert final_err < 0.15, final_err


def test_slam_trajectory_continuous_across_splits(rng):
    slam, gt = _synthetic_run(n_frames=12, step_z=0.4, split_m=1.0, rng=rng)
    traj = slam.trajectory()
    # adjacent frame translation must stay near the commanded 0.4 m step —
    # a discontinuity at a split would violate this
    for a, b in zip(traj[:-1], traj[1:]):
        d = np.linalg.norm(b[:3, 3] - a[:3, 3])
        assert 0.2 < d < 0.6, d


def test_slam_robot_in_world_accessor(rng):
    slam, gt = _synthetic_run(n_frames=6, step_z=0.3, split_m=100.0, rng=rng)
    assert slam.num_maps == 1
    T = slam.robot_in_world()
    err = np.linalg.norm(T[:3, 3] - gt[-1][:3, 3])
    assert err < 0.1, err


def test_slam_loop_closure_path_runs(rng):
    """Out-and-back loop exercises the detect/validate/optimize path."""
    from srrg2_proslam_jax.models.loop_closure import LoopDetectorConfig

    pts_w = _world(rng, n=500)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(500, 256))
    config = GraphSLAMConfig(
        splitting=SplittingConfig(maximum_translation_m=1.0),
        loop=LoopDetectorConfig(minimum_age_difference=2, minimum_matches=25),
        arena_capacity=1024,
        database_capacity=8192,
        enable_loop_closing=True,
    )
    slam = GraphSLAM(CAM, config)
    # forward 3 m, back 3 m: revisits the start viewpoint
    zs = list(np.arange(0, 3.0, 0.3)) + list(np.arange(3.0, -0.01, -0.3))
    for i, z in enumerate(zs):
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[2, 3] = -(-z)  # world->camera translation (camera at +z z)
        T_wc[2, 3] = -z
        p, d, ok = _stereo_measurements(pts_w, desc, T_wc)
        slam.process(p, d, ok, timestamp=0.1 * i)
    assert slam.num_maps >= 3
    # the run must complete with a consistent trajectory whether or not a
    # closure fired (closures need revisits with enough map separation)
    traj = slam.trajectory()
    assert len(traj) == len(zs)
    final_err = np.linalg.norm(traj[-1][:3, 3] - np.array([0, 0, 0.0]))
    assert final_err < 0.5, final_err
