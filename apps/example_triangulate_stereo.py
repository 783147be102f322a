"""Didactic example: stereo adaptation + rigid rectified triangulation.

Parity with the reference's example_triangulate_rigid_stereo.cpp: run the
stereo measurement adaptor on one image pair, triangulate the 4-D
measurements (z = baseline_px / disparity, midpoint v — M1,
triangulator_rigid_stereo.cpp:59-85), print the triangulated/total counts
the reference prints, and — instead of its QGLViewer thread — optionally
export the stereo-match visualization and the 3-D cloud for the offline
viewer (apps/export_viewer.py renders the same artifacts headless).

Usage: python apps/example_triangulate_stereo.py
           [--left L.png --right R.png] [--fx FX --baseline-px B]
           [--render matches.png] [--cloud cloud.npz]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.io import datasets
from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig, adapt_stereo
from srrg2_proslam_jax.ops.pinhole import Camera
from srrg2_proslam_jax.ops.triangulation import triangulate_rectified

ROOT = os.path.join(os.path.dirname(__file__), "..", "test_data")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--left", default=os.path.join(
        ROOT, "kitti", "city", "image_left_0.png"))
    ap.add_argument("--right", default=os.path.join(
        ROOT, "kitti", "city", "image_right_0.png"))
    ap.add_argument("--fx", type=float, default=None,
                    help="focal length (default: bundled-KITTI calibration)")
    ap.add_argument("--baseline-px", type=float, default=None)
    ap.add_argument("--render", default=None,
                    help="write a stereo-match visualization PNG")
    ap.add_argument("--cloud", default=None,
                    help="write the triangulated cloud as .npz (points, valid)")
    args = ap.parse_args()

    L = datasets.load_gray(args.left)
    R = datasets.load_gray(args.right)
    cam = datasets.kitti_camera(*L.shape)
    if args.fx is not None:
        cam = cam._replace(fx=args.fx, fy=args.fx)
    if args.baseline_px is not None:
        cam = cam._replace(baseline_px=args.baseline_px)

    meas = adapt_stereo(jnp.asarray(L), jnp.asarray(R),
                        StereoAdaptorConfig())
    n_meas = int(jnp.sum(meas.valid))
    pts, ok = triangulate_rectified(cam, meas.points, meas.valid)
    n_tri = int(jnp.sum(ok))
    print(f"# stereo measurements: {n_meas}/{meas.points.shape[0]}")
    print(f"# triangulated points: {n_tri}/{n_meas}")
    z = np.asarray(pts[:, 2])[np.asarray(ok)]
    print(f"depth range (m): [{z.min():.2f}, {z.max():.2f}], "
          f"median {np.median(z):.2f}")

    if args.render:
        # top: left image with left keypoints; bottom: right image with the
        # matched right keypoints (the reference's vconcat + green lines)
        canvas = np.concatenate([np.asarray(L), np.asarray(R)], axis=0)
        canvas = np.stack([canvas] * 3, axis=-1).astype(np.uint8)
        H = L.shape[0]
        p = np.asarray(meas.points)
        for (uL, vL, uR, vR), good in zip(p, np.asarray(ok)):
            if not good:
                continue
            canvas[int(vL), int(uL)] = (0, 255, 0)
            canvas[int(vR) + H, int(uR)] = (0, 255, 0)
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(10, 7))
            ax.imshow(canvas)
            for (uL, vL, uR, vR), good in zip(p[::7], np.asarray(ok)[::7]):
                if good:
                    ax.plot([uL, uR], [vL, vR + H], "g-", lw=0.3)
            ax.set_title("stereo matches (top: left, bottom: right)")
            fig.savefig(args.render, dpi=110)
            print(f"match visualization written: {args.render}")
        except Exception as e:  # matplotlib-free fallback: raw canvas
            datasets.save_gray(args.render, canvas.mean(-1))
            print(f"matplotlib unavailable ({e}); wrote gray canvas")

    if args.cloud:
        np.savez(args.cloud, points=np.asarray(pts), valid=np.asarray(ok))
        print(f"triangulated cloud written: {args.cloud} "
              "(render with apps/export_viewer.py)")


if __name__ == "__main__":
    main()
