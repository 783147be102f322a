"""High-speed stress fixture: the 2 bundled KITTI highway frames.

The reference uses these frames as its hard tracking case (KITTI fixture,
fixtures.hpp:863-924, with loosened 10 px "noisy" correspondence gating).
The bundled gt.txt stores the unit DIRECTION of the inter-frame motion;
the test requires the tracker to survive (inliers) and recover the heading.
"""
import os

import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.io import datasets
from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig, adapt_stereo
from srrg2_proslam_jax.models.tracker import TrackerConfig, initial_state, track_step

ROOT = os.path.join(os.path.dirname(__file__), "..", "test_data")


def test_highway_heading_recovered():
    frames = list(datasets.iter_bundled_kitti(ROOT, "highway"))
    assert len(frames) == 2
    cam = datasets.kitti_camera(*frames[0].left.shape)
    acfg, tcfg = StereoAdaptorConfig(), TrackerConfig()
    state = initial_state(4096)
    stats = None
    for fr in frames:
        m = adapt_stereo(jnp.asarray(fr.left), jnp.asarray(fr.right), acfg)
        state, stats, X = track_step(
            state, m.points, m.desc, m.valid, cam, tcfg, "stereo"
        )
    assert int(stats.num_inliers) >= 10
    t = np.asarray(state.T_lm_robot)[:3, 3]
    # gt_pose holds absolute sequence poses (rows 274/275 of the seq-01
    # trajectory); the heading reference is the relative motion 274 -> 275
    T_rel = np.linalg.inv(frames[0].gt_pose) @ frames[1].gt_pose
    gt_dir = T_rel[:3, 3] / np.linalg.norm(T_rel[:3, 3])
    est_dir = t / max(np.linalg.norm(t), 1e-9)
    assert float(est_dir @ gt_dir) > 0.99, (est_dir, gt_dir)
