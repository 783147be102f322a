"""Didactic example: feature extraction + stereo matching on one image pair.

Parity with the reference's didactic apps (example_feature_extraction /
example_feature_matcher_bruteforce / example_sparse_stereo_matching,
reference srrg2_proslam/apps/).  Prints stage-by-stage statistics and
optionally renders a match visualization.

Usage: python apps/example_feature_matching.py [--left L.png --right R.png]
       [--render out.png]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.io import datasets
from srrg2_proslam_jax.ops.features import FeatureExtractorConfig, extract_features
from srrg2_proslam_jax.ops.matching import (
    BruteforceMatcherConfig, EpipolarMatcherConfig,
    match_bruteforce, match_epipolar,
)
from srrg2_proslam_jax.ops.triangulation import triangulate_rectified

ROOT = os.path.join(os.path.dirname(__file__), "..", "test_data")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--left", default=os.path.join(ROOT, "scene_flow", "image_left.png"))
    ap.add_argument("--right", default=os.path.join(ROOT, "scene_flow", "image_right.png"))
    ap.add_argument("--render", default=None)
    args = ap.parse_args()

    L = jnp.asarray(datasets.load_gray(args.left))
    R = jnp.asarray(datasets.load_gray(args.right))
    cfg = FeatureExtractorConfig()

    fl = extract_features(L, cfg)
    fr = extract_features(R, cfg)
    print(f"keypoints: left={int(jnp.sum(fl.valid))} right={int(jnp.sum(fr.valid))} "
          f"(capacity {cfg.max_keypoints}, grid {cfg.grid_rows}x{cfg.grid_cols})")

    bf = match_bruteforce(fl.desc, fl.valid, fr.desc, fr.valid,
                          BruteforceMatcherConfig())
    print(f"brute-force matches (bijective + Lowe): {int(bf.count)}")

    ep = match_epipolar(fl.uv, fl.desc, fl.valid, fr.uv, fr.desc, fr.valid,
                        EpipolarMatcherConfig())
    print(f"epipolar stereo matches: {int(ep.count)}")

    idx = jnp.maximum(ep.idx, 0)
    pts4 = jnp.stack([fl.uv[:, 0], fl.uv[:, 1],
                      fr.uv[idx, 0], fr.uv[idx, 1]], axis=-1)
    cam = datasets.kitti_camera(*L.shape)
    pts3, ok = triangulate_rectified(cam, pts4, ep.mask)
    z = np.asarray(pts3[:, 2])[np.asarray(ok)]
    if z.size:
        print(f"triangulated: {z.size} points, depth 10/50/90%: "
              f"{np.percentile(z, [10, 50, 90]).round(1)} m")

    if args.render:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(12, 5))
        ax.imshow(np.asarray(L), cmap="gray")
        uv = np.asarray(fl.uv)[np.asarray(ep.mask)]
        uvr = np.asarray(fr.uv)[np.asarray(idx)][np.asarray(ep.mask)]
        ax.scatter(uv[:, 0], uv[:, 1], s=6, c="lime")
        for (u0, v0), (u1, _) in zip(uv, uvr):
            ax.plot([u0, u1], [v0, v0], "r-", lw=0.5)
        ax.set_title("left keypoints + disparity vectors")
        fig.savefig(args.render, dpi=120, bbox_inches="tight")
        print(f"wrote {args.render}")


if __name__ == "__main__":
    main()
