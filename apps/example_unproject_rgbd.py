"""Didactic example: dense 3-D unprojection of one RGB-D image pair.

Parity with the reference's example_unproject_rgbd.cpp: load an intensity +
depth image, unproject EVERY valid depth pixel through the pinhole model
(u, v, z) -> ((u-cx)z/fx, (v-cy)z/fy, z) with the range gates
range_min/range_max, and print the unprojected count + timing the
reference prints (example_unproject_rgbd.cpp:93-101; its hardcoded xtion
K = [269.853, 0, 157.051; 0, 269.733, 113.118] is the default here too).
The QGLViewer thread becomes an optional .npz cloud export for the
offline viewer.

Usage: python apps/example_unproject_rgbd.py
           [-i rgb.png -d depth.pgm] [--depth-scale 1e-3] [--cloud out.npz]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from srrg2_proslam_jax.io import datasets

ROOT = os.path.join(os.path.dirname(__file__), "..", "test_data")


def unproject_dense(depth_m: jnp.ndarray, fx, fy, cx, cy,
                    range_min=0.1, range_max=10.0):
    """[H, W] depth (meters) -> ([H*W, 3] camera-frame points, [H*W] valid)."""
    H, W = depth_m.shape
    v = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    u = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    z = depth_m
    pts = jnp.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], axis=-1)
    ok = (z >= range_min) & (z <= range_max)
    return pts.reshape(-1, 3), ok.reshape(-1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image-rgb",
                    default=os.path.join(ROOT, "xtion", "image_rgb.png"))
    ap.add_argument("-d", "--image-depth",
                    default=os.path.join(ROOT, "xtion", "image_depth.pgm"))
    ap.add_argument("--depth-scale", type=float, default=1e-3,
                    help="raw depth units -> meters (bundled PGMs are mm)")
    ap.add_argument("--fx", type=float, default=269.853)
    ap.add_argument("--fy", type=float, default=269.733)
    ap.add_argument("--cx", type=float, default=157.051)
    ap.add_argument("--cy", type=float, default=113.118)
    ap.add_argument("--range-min", type=float, default=0.1)
    ap.add_argument("--range-max", type=float, default=10.0)
    ap.add_argument("--cloud", default=None)
    args = ap.parse_args()

    gray = datasets.load_gray(args.image_rgb)
    depth = jnp.asarray(datasets.load_depth(args.image_depth)
                        * args.depth_scale)
    print(f"image: {gray.shape}, depth: {depth.shape} "
          f"(scale {args.depth_scale})")

    fn = jax.jit(lambda d: unproject_dense(
        d, args.fx, args.fy, args.cx, args.cy,
        args.range_min, args.range_max))
    pts, ok = jax.block_until_ready(fn(depth))   # compile
    t0 = time.perf_counter()
    pts, ok = fn(depth)
    n = int(np.asarray(jnp.sum(ok)))             # consume = honest timing
    dt = time.perf_counter() - t0
    print(f"# unprojected points: {n}")
    print(f"unprojection duration (s): {dt:.4f} (Hz): {1 / dt:.1f}")
    z = np.asarray(pts[:, 2])[np.asarray(ok)]
    print(f"depth median (m): {np.median(z):.3f} "
          f"range [{z.min():.3f}, {z.max():.3f}]")

    if args.cloud:
        np.savez(args.cloud, points=np.asarray(pts), valid=np.asarray(ok),
                 intensity=np.asarray(gray).reshape(-1))
        print(f"cloud written: {args.cloud} "
              "(render with apps/export_viewer.py)")


if __name__ == "__main__":
    main()
