"""Didactic example: frame-to-frame stereo tracking on the bundled frames.

Parity with the reference's didactic tracking app
(example_stereo_projective_tracking, reference srrg2_proslam/apps/
example_stereo_projective_tracking.cpp:133-333): walk a short stereo
sequence, print every pipeline stage per frame — measurements, projective
matches, Gauss-Newton inliers/chi, merges/additions, the matcher's search
stage, and the evolving pose — so a new user can watch the tracker work.

Usage: python apps/example_tracking.py [--sequence kitti_dir] [--count N]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.io import datasets
from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig, adapt_stereo
from srrg2_proslam_jax.models.tracker import (
    TrackerConfig, initial_state, track_step,
)

ROOT = os.path.join(os.path.dirname(__file__), "..", "test_data")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequence", default=None,
                    help="KITTI odometry folder (default: bundled frames)")
    ap.add_argument("--count", type=int, default=None)
    args = ap.parse_args()

    if args.sequence:
        frames = list(datasets.iter_kitti_odometry(args.sequence,
                                                   count=args.count))
    else:
        frames = list(datasets.iter_bundled_kitti(ROOT, "city"))
    cam = datasets.kitti_camera(*frames[0].left.shape)
    acfg = StereoAdaptorConfig()
    tcfg = TrackerConfig()
    state = initial_state(4096)

    print(f"{len(frames)} frames, camera fx={cam.fx:.1f} "
          f"baseline={cam.baseline_px / cam.fx:.3f} m")
    print(f"{'frame':>5} {'meas':>5} {'match':>6} {'inl':>5} {'chi/inl':>8} "
          f"{'merge':>6} {'add':>5} {'stage':>5} {'map':>5}  pose t [m]")
    for i, fr in enumerate(frames):
        meas = adapt_stereo(jnp.asarray(fr.left), jnp.asarray(fr.right),
                            acfg)
        state, stats, _ = track_step(state, meas.points, meas.desc,
                                     meas.valid, cam, tcfg, "stereo")
        pkt = np.asarray(stats.host_packet)   # [20]: 8 scalars + T[:3,:]
        t = pkt[8 + 3], pkt[8 + 7], pkt[8 + 11]  # T rows 0..2, col 3
        print(f"{i:5d} {int(np.asarray(stats.num_measurements)):5d} "
              f"{int(pkt[3]):6d} {int(pkt[0]):5d} {pkt[6]:8.2f} "
              f"{int(pkt[4]):6d} {int(pkt[5]):5d} {int(pkt[7]):5d} "
              f"{int(np.asarray(state.arena.count)):5d}  "
              f"[{t[0]:7.3f} {t[1]:7.3f} {t[2]:7.3f}]")


if __name__ == "__main__":
    main()
