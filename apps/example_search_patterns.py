"""Didactic example: the projective matcher's search-region patterns.

Parity with the reference's example_projective_search_patterns.cpp, which
rasterizes the square / circle / rhombus candidate regions of the
projective correspondence finders (R5/R6) onto a 500x500 canvas.  Here the
SAME predicate the device matcher evaluates — ``_geometric_distance(delta,
norm) <= radius`` over a dense pixel grid (ops/matching.py:182-187; the
four reference lattice scans collapse into this one masked distance) —
paints each region at the reference's sample positions and radii, and the
canvas is written as a PGM next to an ASCII thumbnail.

Usage: python apps/example_search_patterns.py [--out patterns.pgm]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.ops.matching import _geometric_distance

#: (radius, row, col) samples of the reference example (rows 60-76)
SAMPLES = [(100, 150, 150), (50, 325, 325), (10, 410, 410), (5, 450, 450)]
#: norm -> painted intensity (reference uses 75 / 150 / 255)
PATTERNS = [("square", 75), ("circle", 150), ("rhombus", 255)]


def paint(canvas: np.ndarray, norm: str, color: int):
    H, W = canvas.shape
    r = jnp.arange(H, dtype=jnp.float32)[:, None]
    c = jnp.arange(W, dtype=jnp.float32)[None, :]
    for radius, row, col in SAMPLES:
        delta = jnp.stack(
            [jnp.broadcast_to(c - col, (H, W)),
             jnp.broadcast_to(r - row, (H, W))], axis=-1)
        inside = _geometric_distance(delta, norm) <= radius
        canvas[np.asarray(inside)] = color
    return canvas


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="patterns.pgm")
    args = ap.parse_args()

    canvas = np.zeros((500, 500), np.uint8)
    for norm, color in PATTERNS:
        canvas = paint(canvas, norm, color)
        area = int((canvas == color).sum())
        print(f"{norm:8s} regions painted at {len(SAMPLES)} scales "
              f"(intensity {color}, {area} px visible)")

    from srrg2_proslam_jax.io.datasets import save_gray
    save_gray(args.out, canvas.astype(np.float32))
    print(f"canvas written: {args.out} "
          "(square | circle | rhombus, like the reference window)")

    # ASCII thumbnail (headless hosts have no display)
    th = canvas[::12, ::6]
    chars = np.array([" ", ".", "o", "#"])
    idx = np.searchsorted([1, 100, 200], th)
    for line in chars[idx]:
        print("".join(line))


if __name__ == "__main__":
    main()
