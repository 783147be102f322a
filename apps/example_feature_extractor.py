"""Didactic example: binned + selective (seeded) feature extraction.

Parity with the reference's example_feature_extractor.cpp: detect keypoints
on a "moving" image with the binned extractor (per-grid-region top-K), then
— seeding mode — re-detect on a "fixed" image restricted to masks around
the moving keypoints' projections, over 20 iterations with a shrinking
detection radius round(100 / (i + 1)) exactly like the reference's loop
(example_feature_extractor.cpp:112-133), printing extracted counts and
timings per iteration.

Usage: python apps/example_feature_extractor.py
           [--moving M.png] [--fixed F.png] [-n 100] [--seeded]
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
from srrg2_proslam_jax.ops import features as F

ROOT = os.path.join(os.path.dirname(__file__), "..", "test_data")


def radius_mask(rows, cols, uv, valid, radius):
    """Binary detection mask: True within ``radius`` px of a valid seed
    (the selective extractor's projection masks,
    intensity_feature_extractor_selective.cpp:66-67)."""
    r = jax.lax.broadcasted_iota(jnp.float32, (rows, cols), 0)
    c = jax.lax.broadcasted_iota(jnp.float32, (rows, cols), 1)
    u = jnp.where(valid, uv[:, 0], -1e9)
    v = jnp.where(valid, uv[:, 1], -1e9)
    d2 = (r[:, :, None] - v[None, None, :]) ** 2 \
        + (c[:, :, None] - u[None, None, :]) ** 2
    return jnp.min(d2, axis=-1) <= radius * radius


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--moving", default=os.path.join(
        ROOT, "scene_flow", "image_left.png"))
    ap.add_argument("--fixed", default=None,
                    help="measurement image (default: same as --moving)")
    ap.add_argument("-n", "--keypoints", type=int, default=100)
    ap.add_argument("--threshold", type=float, default=10.0)
    ap.add_argument("--seeded", action="store_true",
                    help="selective mode: mask detection around the moving "
                         "image's keypoints (reference -es flag)")
    args = ap.parse_args()

    moving = jnp.asarray(datasets.load_gray(args.moving))
    fixed = jnp.asarray(datasets.load_gray(args.fixed or args.moving))
    H, W = moving.shape
    cfg = F.FeatureExtractorConfig(
        max_keypoints=args.keypoints, detector_threshold=args.threshold)

    t0 = time.perf_counter()
    uv, resp, valid = detect = F.detect_keypoints(moving, cfg)
    n = int(jnp.sum(valid))
    dt = time.perf_counter() - t0
    print(f"MOVING image (seeding): {args.moving}")
    print(f"  # target keypoints: {args.keypoints}")
    print(f"  # extracted features: {n}")
    print(f"  extraction duration (s): {dt:.4f} (Hz): {1 / dt:.1f}")

    if not args.seeded:
        # binned mode: the detector grid IS the binning (S2); report the
        # per-region distribution
        gr, gc = cfg.grid_rows, cfg.grid_cols
        counts = np.zeros((gr, gc), int)
        for (u, v), ok in zip(np.asarray(uv), np.asarray(valid)):
            if ok:
                counts[min(int(v) * gr // H, gr - 1),
                       min(int(u) * gc // W, gc - 1)] += 1
        print(f"  per-region counts ({gr}x{gc} grid):")
        for row in counts:
            print("   ", " ".join(f"{c:3d}" for c in row))
        return

    # selective/tracking mode: shrinking detection radius, reference loop
    for i in range(20):
        radius = round(100.0 / (i + 1))
        t0 = time.perf_counter()
        mask = radius_mask(H, W, uv, valid, radius)
        uv2, _, valid2 = F.detect_keypoints(fixed, cfg, mask=mask)
        n2 = int(jnp.sum(valid2))
        dt = time.perf_counter() - t0
        print("-" * 67)
        print(f"iteration: {i}")
        print(f"  detection radius (px): {radius}")
        print(f"  # extracted features: {n2}")
        print(f"  extraction duration (s): {dt:.4f} (Hz): {1 / dt:.1f}")


if __name__ == "__main__":
    main()
