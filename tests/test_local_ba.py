"""Split-time local BA must refine the finished map's landmarks."""
import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.models.slam import (
    GraphSLAM, GraphSLAMConfig, LocalBAConfig, SplittingConfig,
)
from tests.test_slam import CAM, _world, _stereo_measurements


def _landmark_error_vs_world(slam, pts_w, map_id=0):
    """Median distance of map landmarks to their nearest true world point."""
    arena = slam._map_arenas[map_id]
    T_w_lm = np.asarray(slam.graph.poses[map_id])
    lm_world = arena.pos @ T_w_lm[:3, :3].T + T_w_lm[:3, 3]
    lm_world = lm_world[arena.valid]
    d = np.linalg.norm(lm_world[:, None, :] - pts_w[None, :, :], axis=-1)
    return float(np.median(d.min(axis=1)))


def _run(rng_seed, enabled):
    rng = np.random.RandomState(rng_seed)
    pts_w = _world(rng)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(pts_w.shape[0], 256))
    config = GraphSLAMConfig(
        splitting=SplittingConfig(maximum_translation_m=2.0),
        local_ba=LocalBAConfig(enabled=enabled, max_keyframes=6,
                               keyframe_stride=1),
        arena_capacity=1024,
        enable_loop_closing=False,
    )
    slam = GraphSLAM(CAM, config)
    T_wc = np.eye(4, dtype=np.float32)
    for i in range(10):
        # measurement noise so BA has something to clean up
        p, d, ok = _stereo_measurements(pts_w, desc, T_wc)
        noise = rng.normal(0, 0.3, p.shape).astype(np.float32)
        slam.process(p + noise, d, ok, timestamp=0.1 * i)
        T_wc[2, 3] -= 0.3
    return slam, pts_w


def test_local_ba_runs_and_keeps_map_quality(rng):
    slam_off, pts_w = _run(7, enabled=False)
    slam_on, _ = _run(7, enabled=True)
    assert slam_on.num_maps >= 2 and 0 in slam_on._map_arenas
    e_off = _landmark_error_vs_world(slam_off, pts_w)
    e_on = _landmark_error_vs_world(slam_on, pts_w)
    # BA must not degrade the map, and typically improves it
    assert e_on <= e_off * 1.1, (e_off, e_on)
    # trajectory stays consistent
    traj = slam_on.trajectory()
    final_err = np.linalg.norm(traj[-1][:3, 3] - [0, 0, 2.7])
    assert final_err < 0.2, final_err
