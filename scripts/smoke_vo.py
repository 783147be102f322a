"""Smoke test: 5-frame open-loop VO on the bundled KITTI city frames.

Mirrors the reference integration test (tests/test_trackers.cpp:327-365):
final pose error vs GT must be within (0.2, 0.2, 0.7) m and 0.01 rad.
Run: python scripts/smoke_vo.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from srrg2_proslam_jax.io import datasets
from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig, adapt_stereo
from srrg2_proslam_jax.models.tracker import (
    TrackerConfig, initial_state, track_step,
)
from srrg2_proslam_jax.ops import se3

ROOT = os.path.join(os.path.dirname(__file__), "..", "test_data")


def main():
    frames = list(datasets.iter_bundled_kitti(ROOT, "city"))
    cam = datasets.kitti_camera(*frames[0].left.shape)
    print(f"{len(frames)} frames, image {frames[0].left.shape}, cam {cam}")

    adaptor_cfg = StereoAdaptorConfig()
    tracker_cfg = TrackerConfig()
    state = initial_state(capacity=4096)

    poses = []
    t0 = time.time()
    for i, fr in enumerate(frames):
        meas = adapt_stereo(jnp.asarray(fr.left), jnp.asarray(fr.right), adaptor_cfg)
        state, stats, X = track_step(
            state, meas.points, meas.desc, meas.valid, cam, tracker_cfg, "stereo"
        )
        pose = np.asarray(state.T_lm_robot)
        poses.append(pose)
        print(
            f"frame {i}: meas={int(stats.num_measurements)} "
            f"matches={int(stats.num_matches)} inliers={int(stats.num_inliers)} "
            f"chi/inl={float(stats.chi_per_inlier):.2f} "
            f"merges={int(stats.num_merges)} adds={int(stats.num_additions)} "
            f"stage={int(stats.matcher_stage)} map={int(state.arena.count)} "
            f"t={pose[:3,3].round(3)}"
        )
    dt = time.time() - t0
    print(f"wall: {dt:.2f}s ({len(frames)/dt:.2f} fps incl. compile)")

    gt_final = frames[-1].gt_pose
    est_final = poses[-1]
    t_err, angle = se3.error_t_and_angle(
        jnp.asarray(est_final), jnp.asarray(gt_final)
    )
    print("GT final t:", gt_final[:3, 3].round(3))
    print("per-axis |t err|:", np.asarray(t_err).round(4), "angle:", float(angle))
    ok = np.all(np.asarray(t_err) <= np.array([0.2, 0.2, 0.7])) and float(angle) <= 0.01
    print("PASS" if ok else "FAIL")


if __name__ == "__main__":
    main()
