"""Sparse stereo ground-truth generator (reference A4 tool parity).

Parity with the reference's compute_sparse_stereo_gt.cpp: detect keypoints
on the left image, look each up in a DENSE left-to-right disparity image,
and write the validated stereo matches as
``gt_stereo_matching_threshold-<t>.txt`` lines

    row col_left  row col_right  disparity      (col_right = col_left - d)

— the exact format of the bundled ``test_data/scene_flow`` fixtures the
stereo-quality tests consume (tests/test_stereo_quality.py), sorted
ascending by row like the reference's output
(compute_sparse_stereo_gt.cpp:100-122).  Disparity inputs: SceneFlow-style
``.pfm`` (the reference's readPFM format), ``.npy``/``.npz``, or a
16-bit PNG/PGM with ``--disparity-scale`` (KITTI-style /256).

Usage: python apps/compute_sparse_stereo_gt.py
           -l left.png -r right.png -d disparity.pfm [-t 10] [-o out_dir]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.io import datasets
from srrg2_proslam_jax.ops import features as F


def load_disparity(path: str, scale: float) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        return datasets.read_pfm(path)
    if ext == ".npy":
        return np.load(path).astype(np.float32)
    if ext == ".npz":
        z = np.load(path)
        return z[list(z.files)[0]].astype(np.float32)
    return datasets.load_depth(path).astype(np.float32) * scale


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-l", "--image-left", required=True)
    ap.add_argument("-r", "--image-right", required=True)
    ap.add_argument("-d", "--image-disparity", required=True)
    ap.add_argument("-t", "--detector-threshold", type=int, default=10)
    ap.add_argument("--disparity-scale", type=float, default=1.0,
                    help="raw units -> pixels for integer disparity images")
    ap.add_argument("-n", "--keypoints", type=int, default=2000)
    ap.add_argument("-o", "--out-dir", default=".")
    args = ap.parse_args()

    L = datasets.load_gray(args.image_left)
    R = datasets.load_gray(args.image_right)
    disp = load_disparity(args.image_disparity, args.disparity_scale)
    if L.shape != R.shape:
        sys.exit("ERROR: image right has inconsistent dimension w.r.t. left")
    if L.shape != disp.shape:
        sys.exit("ERROR: disparity image has inconsistent dimension "
                 f"w.r.t. left ({disp.shape} vs {L.shape})")

    cfg = F.FeatureExtractorConfig(
        max_keypoints=args.keypoints,
        detector_threshold=float(args.detector_threshold))
    uv, _, valid = F.detect_keypoints(jnp.asarray(L), cfg)
    uv = np.asarray(uv)
    valid = np.asarray(valid)
    print(f" # detected keypoints (LEFT): {int(valid.sum())}")

    rows = []
    for (u, v), ok in zip(uv, valid):
        if not ok:
            continue
        c, r = int(round(u)), int(round(v))
        d = float(disp[r, c])
        if d <= 0:                    # invalid disparity -> skip
            continue
        c_right = c - d
        if c_right < 0:               # out of the right image -> skip
            continue
        rows.append((r, c, r, c_right, d))
    rows.sort()

    out = os.path.join(
        args.out_dir,
        f"gt_stereo_matching_threshold-{args.detector_threshold}.txt")
    with open(out, "w") as f:
        for r, c, r2, cr, d in rows:
            f.write(f"{r} {c} {r2} {cr:.6g} {d:.6g}\n")
    print(f" # validated stereo matches: {len(rows)}")
    print(f"ground truth written: {out}")


if __name__ == "__main__":
    main()
