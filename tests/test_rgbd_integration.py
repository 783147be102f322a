"""RGB-D pipeline integration on the bundled ICL-NUIM frames.

Reference tier-2 fixture parity (srrg2_proslam/tests/fixtures.hpp:555-794):
the 3 bundled ICL frames (ids 0, 1, 50) with the GT poses the reference
pins at fixtures.hpp:597-615 (camera_00 at (0,0,-2.25), identity rotation;
camera_01 displaced ~9 mm).  Drives the real adaptor + tracker and checks
the estimated relative pose against camera_01_in_00.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from srrg2_proslam_jax.io import datasets
from srrg2_proslam_jax.io.quaternions import quaternion_to_rotation
from srrg2_proslam_jax.models.frontend import DepthAdaptorConfig, adapt_rgbd
from srrg2_proslam_jax.models.tracker import TrackerConfig, initial_state, track_step
from srrg2_proslam_jax.ops import se3

ROOT = os.path.join(os.path.dirname(__file__), "..", "test_data")


def _pose(t, q_wxyz):
    T = np.eye(4, dtype=np.float32)
    w, x, y, z = q_wxyz
    T[:3, :3] = quaternion_to_rotation(np.array([x, y, z, w]))
    T[:3, 3] = t
    return T


# GT camera-in-world poses (fixtures.hpp:597-608)
T_W_C0 = _pose([0.0, 0.0, -2.25], [1.0, 0.0, 0.0, 0.0])
T_W_C1 = _pose([0.000466347, 0.00895357, -2.24935],
               [0.999999, -0.00101358, 0.00052453, -0.000231475])
GT_C1_IN_C0 = np.linalg.inv(T_W_C0) @ T_W_C1


@pytest.fixture(scope="module")
def icl_frames():
    return list(datasets.iter_bundled_icl(ROOT))


def test_rgbd_measurements_sane(icl_frames):
    cfg = DepthAdaptorConfig()
    m = adapt_rgbd(jnp.asarray(icl_frames[0].intensity),
                   jnp.asarray(icl_frames[0].depth), cfg)
    n = int(m.count)
    assert n > 200, n
    depths = np.asarray(m.points[:, 2])[np.asarray(m.valid)]
    # bundled ICL depth is millimeters scaled by 1e-3: room-scale values
    assert 1.0 < np.median(depths) < 6.0, np.median(depths)


def test_rgbd_frame_to_frame_pose(icl_frames):
    cam = datasets.icl_camera()
    acfg = DepthAdaptorConfig()
    tcfg = TrackerConfig()
    state = initial_state(4096)
    for fr in icl_frames[:2]:
        m = adapt_rgbd(jnp.asarray(fr.intensity), jnp.asarray(fr.depth), acfg)
        state, stats, X = track_step(
            state, m.points, m.desc, m.valid, cam, tcfg, "rgbd"
        )
    assert int(stats.num_inliers) > 30
    # estimated robot pose in the local map == camera_01 in camera_00
    t_err, ang = se3.error_t_and_angle(
        state.T_lm_robot, jnp.asarray(GT_C1_IN_C0)
    )
    # GT displacement is ~9 mm; require the estimate within 5 mm and the
    # reference integration-test rotation envelope of 0.01 rad
    # (tests/test_trackers.cpp:359-364)
    assert float(jnp.max(t_err)) < 5e-3, np.asarray(t_err)
    assert float(ang) < 1e-2, float(ang)
