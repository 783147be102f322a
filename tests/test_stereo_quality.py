"""Stereo matching quality vs the bundled scene-flow ground truth.

Reference tier-2 fixture parity (srrg2_proslam/tests/fixtures.hpp:515-535 +
test_measurement_adaptors.cpp:21-56): run the stereo adaptor on the bundled
960x540 pair and count disparity inliers at 1 px error against the sparse GT
generated by apps/compute_sparse_stereo_gt.cpp.  The reference's own OpenCV
pipeline scores 43/83 and 59/115 inliers (~52%) on this fixture; the bounds
here require at least 60% — strictly better — plus sub-half-pixel median
accuracy (SURVEY.md §4.3: tolerance bounds, not exact counts).
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from srrg2_proslam_jax.io import datasets
from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig, adapt_stereo

ROOT = os.path.join(os.path.dirname(__file__), "..", "test_data")


@pytest.fixture(scope="module")
def scene_flow():
    L = datasets.load_gray(os.path.join(ROOT, "scene_flow", "image_left.png"))
    R = datasets.load_gray(os.path.join(ROOT, "scene_flow", "image_right.png"))
    gt = {}
    path = os.path.join(ROOT, "scene_flow", "gt_stereo_matching_threshold-10.txt")
    with open(path) as f:
        for line in f:
            r, c, _, _, d = line.split()
            gt[(int(r), int(c))] = float(d)
    return L, R, gt


def _evaluate(points, valid, gt):
    n_with_gt = 0
    n_inliers = 0
    abs_errs = []
    for (uL, vL, uR, vR), ok in zip(np.asarray(points), np.asarray(valid)):
        if not ok:
            continue
        key = (int(round(vL)), int(round(uL)))
        if key not in gt:
            continue
        n_with_gt += 1
        err = abs(abs(uL - uR) - gt[key])
        abs_errs.append(err)
        if err < 1.0:
            n_inliers += 1
    return n_with_gt, n_inliers, np.array(abs_errs)


def test_stereo_adaptor_beats_reference_inlier_ratio(scene_flow):
    L, R, gt = scene_flow
    m = adapt_stereo(jnp.asarray(L), jnp.asarray(R), StereoAdaptorConfig())
    n_gt, n_in, errs = _evaluate(m.points, m.valid, gt)
    assert n_gt > 150, n_gt                      # enough evaluable matches
    ratio = n_in / n_gt
    assert ratio >= 0.60, (n_in, n_gt, ratio)    # reference scores ~0.52
    assert np.median(errs) < 0.5                 # sub-half-pixel accuracy


def test_stereo_adaptor_subpixel_no_regression(scene_flow):
    L, R, gt = scene_flow
    m_int = adapt_stereo(jnp.asarray(L), jnp.asarray(R),
                         StereoAdaptorConfig(subpixel_refinement=False))
    m_sub = adapt_stereo(jnp.asarray(L), jnp.asarray(R),
                         StereoAdaptorConfig(subpixel_refinement=True))
    _, n_in_int, _ = _evaluate(m_int.points, m_int.valid, gt)
    _, n_in_sub, _ = _evaluate(m_sub.points, m_sub.valid, gt)
    # sub-pixel refinement must not lose inliers at the 1 px gate
    assert n_in_sub >= n_in_int - 3, (n_in_sub, n_in_int)
