"""Profiling utility and trajectory-export smoke tests."""
import os

import numpy as np

from srrg2_proslam_jax.io import datasets
from srrg2_proslam_jax.io.quaternions import (
    quaternion_to_rotation, rotation_to_quaternion,
)
from srrg2_proslam_jax.utils import profiling


def test_profile_time_accumulates():
    profiling.reset()
    profiling.enable(True)
    try:
        with profiling.profile_time("stage_a"):
            pass
        with profiling.profile_time("stage_a"):
            pass
        with profiling.profile_time("stage_b"):
            pass
    finally:
        profiling.enable(False)
    s = profiling.stats()
    assert s["stage_a"]["calls"] == 2
    assert s["stage_b"]["calls"] == 1
    report = profiling.report()
    assert "stage_a" in report and "ms/call" in report


def test_profile_time_noop_when_disabled():
    profiling.reset()
    profiling.enable(False)
    with profiling.profile_time("hidden"):
        pass
    assert "hidden" not in profiling.stats()


def test_quaternion_roundtrip(rng):
    for _ in range(20):
        v = rng.normal(0, 1, 3)
        angle = rng.uniform(0, np.pi * 0.95)
        axis = v / np.linalg.norm(v)
        # Rodrigues
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K
        q = rotation_to_quaternion(R)
        R2 = quaternion_to_rotation(q)
        np.testing.assert_allclose(R, R2, atol=1e-9)


def test_trajectory_export_roundtrip(tmp_path, rng):
    poses = []
    T = np.eye(4)
    for _ in range(5):
        T = T.copy()
        T[:3, 3] += rng.normal(0, 1, 3)
        poses.append(T)
    kitti = str(tmp_path / "traj_kitti.txt")
    tum = str(tmp_path / "traj_tum.txt")
    datasets.write_kitti_trajectory(kitti, poses)
    datasets.write_tum_trajectory(tum, [0.1 * i for i in range(5)], poses)
    back = np.loadtxt(kitti).reshape(-1, 3, 4)
    np.testing.assert_allclose(back[:, :, 3],
                               np.stack([p[:3, 3] for p in poses]), atol=1e-6)
    rows = np.loadtxt(tum)
    assert rows.shape == (5, 8)
    np.testing.assert_allclose(rows[:, 1:4],
                               np.stack([p[:3, 3] for p in poses]), atol=1e-5)
