"""Smoke test: full GraphSLAM (local maps + splitting) on bundled KITTI city.

Forces a small splitting threshold so the 5 frames exercise local-map
creation, graph edges, and trajectory unrolling; checks the same reference
integration bound as smoke_vo (tests/test_trackers.cpp:327-365).
Run: python scripts/smoke_slam.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.io import datasets
from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig, adapt_stereo
from srrg2_proslam_jax.models.slam import GraphSLAM, GraphSLAMConfig, SplittingConfig
from srrg2_proslam_jax.ops import se3

ROOT = os.path.join(os.path.dirname(__file__), "..", "test_data")


def main():
    frames = list(datasets.iter_bundled_kitti(ROOT, "city"))
    cam = datasets.kitti_camera(*frames[0].left.shape)
    acfg = StereoAdaptorConfig()
    config = GraphSLAMConfig(
        splitting=SplittingConfig(maximum_translation_m=1.5),
        enable_loop_closing=True,
    )
    slam = GraphSLAM(cam, config)

    t0 = time.time()
    for i, fr in enumerate(frames):
        meas = adapt_stereo(jnp.asarray(fr.left), jnp.asarray(fr.right), acfg)
        stats = slam.process(meas.points, meas.desc, meas.valid, fr.timestamp)
        T = slam.robot_in_world()
        print(
            f"frame {i}: status={slam.status} maps={slam.num_maps} "
            f"edges={slam.num_edges} inliers={int(stats.num_inliers)} "
            f"t={T[:3,3].round(3)}"
        )
    dt = time.time() - t0
    print(f"wall: {dt:.2f}s  local maps: {slam.num_maps}  closures: {slam.num_closures}")

    traj = slam.trajectory()
    gt_final = frames[-1].gt_pose
    t_err, angle = se3.error_t_and_angle(
        jnp.asarray(traj[-1].astype(np.float32)), jnp.asarray(gt_final)
    )
    print("per-axis |t err|:", np.asarray(t_err).round(4), "angle:", float(angle))
    ok = np.all(np.asarray(t_err) <= np.array([0.2, 0.2, 0.7])) and float(angle) <= 0.01
    print("PASS" if ok else "FAIL")


if __name__ == "__main__":
    main()
