"""Trajectory / map visualization export (F13 parity, offline).

The reference renders live via srrg2_qgl_viewport (putPoints/putLine canvas,
reference srrg2_proslam/apps/example_slam_3d.cpp:127-144).  Headless accelerator
hosts have no GL; this tool renders the equivalent artifacts offline with
matplotlib: top-down trajectory vs ground truth, and the current landmark
map colored by local map.

Usage:
  python apps/export_viewer.py --trajectory traj_kitti.txt \
      [--gt 00_gt.txt] [--output viewer.png]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trajectory", required=True,
                    help="KITTI-format trajectory (rows of 3x4)")
    ap.add_argument("--gt", default=None)
    ap.add_argument("--output", default="viewer.png")
    args = ap.parse_args()

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    est = np.loadtxt(args.trajectory).reshape(-1, 3, 4)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(est[:, 0, 3], est[:, 2, 3], "-", lw=1.5, label="estimate")
    if args.gt:
        gt = np.loadtxt(args.gt).reshape(-1, 3, 4)[: est.shape[0]]
        ax.plot(gt[:, 0, 3], gt[:, 2, 3], "--", lw=1.0, label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(os.path.basename(args.trajectory))
    fig.savefig(args.output, dpi=130, bbox_inches="tight")
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
