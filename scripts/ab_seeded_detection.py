"""A/B: dense detection vs seeded (stripe-masked) right-camera detection.

Round-2 verdict item 8: PARITY.md claims dense detection subsumes the
reference's seeded/selective extractor (S3,
intensity_feature_extractor_selective.cpp:66-174) — this script measures the
claim on the rendered sequence, including a low-texture (contrast-crushed)
stretch:

  * stereo match count + recall against exact rendered disparities
    (sparse_stereo_gt, the reference's GT methodology);
  * short-horizon VO tracking inliers with each variant's measurements.

Run:  python scripts/ab_seeded_detection.py  (CPU or GPU)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from srrg2_proslam_jax.utils.compile_cache import enable_compile_cache
from srrg2_proslam_jax.io import synthetic as syn
from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig
from srrg2_proslam_jax.models.tracker import TrackerConfig, initial_state, track_step
from srrg2_proslam_jax.ops import features as F
from srrg2_proslam_jax.ops.matching import match_epipolar
from srrg2_proslam_jax.ops.subpixel import refine_disparity


def adapt_variant(left, right, acfg, seeded: bool):
    """adapt_stereo with optional seeded right-camera detection."""
    feats_l = F.extract_features(left, acfg.extractor)
    mask = None
    if seeded:
        mask = F.stripe_mask(right.shape[0], right.shape[1],
                             feats_l.uv[:, 1], feats_l.valid,
                             thickness=acfg.matcher.epipolar_thickness_px)
    feats_r = F.extract_features(right, acfg.extractor, mask)
    m = match_epipolar(feats_l.uv, feats_l.desc, feats_l.valid,
                       feats_r.uv, feats_r.desc, feats_r.valid, acfg.matcher)
    idx = jnp.maximum(m.idx, 0)
    uv_r = feats_r.uv[idx]
    u_r = refine_disparity(left, right, feats_l.uv, uv_r)
    disparity = feats_l.uv[:, 0] - u_r
    ok = m.mask & (disparity >= acfg.minimum_disparity_px)
    v = 0.5 * (feats_l.uv[:, 1] + uv_r[:, 1])
    points = jnp.stack([feats_l.uv[:, 0], v, u_r, v], axis=-1)
    return (jnp.where(ok[:, None], points, 0.0),
            jnp.where(ok[:, None], feats_l.desc, jnp.int8(-1)), ok,
            feats_l, disparity)


def main():
    enable_compile_cache()
    cam = syn.synthetic_camera(rows=320, cols=416, fx=300.0)
    planes = syn.make_room(size_x=18.0, size_z=26.0)
    poses = syn.loop_trajectory(side_a=8.0, side_b=6.0, step_m=0.4,
                                turn_frames=8)[:60]
    acfg = StereoAdaptorConfig()
    tcfg = TrackerConfig()
    jit_adapt = {
        s: jax.jit(lambda l, r, s=s: adapt_variant(l, r, acfg, s))
        for s in (False, True)
    }

    stats = {False: dict(matches=0, correct=0, inliers=0, frames=0),
             True: dict(matches=0, correct=0, inliers=0, frames=0)}
    states = {False: initial_state(4096), True: initial_state(4096)}

    for i, T_wc in enumerate(poses):
        left, right, depth = syn.render_stereo(cam, jnp.asarray(T_wc), planes)
        if 24 <= i < 30:   # low-texture stretch: 85% contrast crush
            left = syn.crush_exposure(left, 0.85)
            right = syn.crush_exposure(right, 0.85)
        depth_np = np.asarray(depth)
        for seeded in (False, True):
            pts, desc, ok, feats_l, disp = jit_adapt[seeded](left, right)
            pts_np, ok_np = np.asarray(pts), np.asarray(ok)
            disp_np = np.asarray(disp)
            # GT disparity at the matched left keypoints
            u = np.clip(pts_np[:, 0].astype(int), 0, cam.cols - 1)
            v = np.clip(pts_np[:, 1].astype(int), 0, cam.rows - 1)
            z = depth_np[v, u]
            gt_disp = cam.baseline_px / np.maximum(z, 1e-3)
            correct = ok_np & np.isfinite(z) & (
                np.abs(disp_np - gt_disp) <= 1.0)
            stats[seeded]["matches"] += int(ok_np.sum())
            stats[seeded]["correct"] += int(correct.sum())
            st, ts, _ = track_step(states[seeded], pts, desc, jnp.asarray(ok_np),
                                   cam, tcfg, "stereo")
            states[seeded] = st
            stats[seeded]["inliers"] += int(ts.num_inliers)
            stats[seeded]["frames"] += 1

    print(f"{'variant':10s} {'stereo matches':>16s} {'1px-recall':>12s} "
          f"{'VO inliers/frame':>18s}")
    for seeded in (False, True):
        s = stats[seeded]
        name = "seeded" if seeded else "dense"
        prec = s["correct"] / max(s["matches"], 1)
        print(f"{name:10s} {s['matches'] / s['frames']:16.1f} "
              f"{prec:12.3f} {s['inliers'] / s['frames']:18.1f}")


if __name__ == "__main__":
    main()
