"""Smoke test: RGB-D tracking on the bundled ICL frames.

Checks the estimated frame-0 -> frame-1 motion against the GT poses the
reference fixture pins (fixtures.hpp:597-615), through the full public API.
Run: python scripts/smoke_rgbd.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.io import datasets
from srrg2_proslam_jax.io.quaternions import quaternion_to_rotation
from srrg2_proslam_jax.models.frontend import DepthAdaptorConfig, adapt_rgbd
from srrg2_proslam_jax.models.slam import GraphSLAM, GraphSLAMConfig
from srrg2_proslam_jax.ops import se3

ROOT = os.path.join(os.path.dirname(__file__), "..", "test_data")


def _pose(t, q_wxyz):
    T = np.eye(4, dtype=np.float32)
    w, x, y, z = q_wxyz
    T[:3, :3] = quaternion_to_rotation(np.array([x, y, z, w]))
    T[:3, 3] = t
    return T


def main():
    frames = list(datasets.iter_bundled_icl(ROOT))
    cam = datasets.icl_camera()
    slam = GraphSLAM(cam, GraphSLAMConfig(), model="rgbd")
    acfg = DepthAdaptorConfig()

    for i, fr in enumerate(frames[:2]):
        m = adapt_rgbd(jnp.asarray(fr.intensity), jnp.asarray(fr.depth), acfg)
        stats = slam.process(m.points, m.desc, m.valid, float(i))
        print(f"frame {i}: meas={int(stats.num_measurements)} "
              f"inliers={int(stats.num_inliers)} map={int(slam.current_local_map().count)}")

    T_w_c0 = _pose([0.0, 0.0, -2.25], [1, 0, 0, 0])
    T_w_c1 = _pose([0.000466347, 0.00895357, -2.24935],
                   [0.999999, -0.00101358, 0.00052453, -0.000231475])
    gt = np.linalg.inv(T_w_c0) @ T_w_c1
    est = slam.robot_in_world()
    t_err, ang = se3.error_t_and_angle(jnp.asarray(est.astype(np.float32)),
                                       jnp.asarray(gt))
    print("per-axis |t err|:", np.asarray(t_err).round(5), "angle:", float(ang))
    ok = np.all(np.asarray(t_err) <= 5e-3) and float(ang) <= 0.01
    print("PASS" if ok else "FAIL")


if __name__ == "__main__":
    main()
