"""Diagnostics for the rendered-sequence pipeline (dev tool).

Part 1: stereo adaptor quality vs exact rendered GT disparity
         (the sparse_stereo_gt analog of the reference's
          evaluateStereoMatches, tests/fixtures.hpp:515-535).
Part 2: per-frame trace of the full SLAM loop: inliers, matcher stage,
         position/yaw error, wall time per stage.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.io import synthetic as syn
from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig, adapt_stereo
from srrg2_proslam_jax.models.loop_closure import LoopDetectorConfig
from srrg2_proslam_jax.models.slam import (
    GraphSLAM, GraphSLAMConfig, SplittingConfig,
)
from srrg2_proslam_jax.models.tracker import TrackerConfig


def part1_stereo_quality(n_frames=3):
    cam = syn.synthetic_camera()
    planes = syn.make_room(size_x=22.0, size_z=32.0)
    poses = syn.loop_trajectory()
    acfg = StereoAdaptorConfig()
    for i in [0, 60, 75]:
        T_wc = jnp.asarray(poses[i])
        left, right, depth = syn.render_stereo(cam, T_wc, planes)
        meas = adapt_stereo(left, right, acfg)
        pts = np.asarray(meas.points)
        ok = np.asarray(meas.valid)
        uv = pts[ok, :2]
        disp = pts[ok, 0] - pts[ok, 2]
        gt_disp = syn.sparse_stereo_gt(cam, np.asarray(depth), uv)
        err = np.abs(disp - gt_disp)
        fin = np.isfinite(gt_disp)
        print(f"frame {i}: n_feat={ok.sum()} inlier@1px="
              f"{(err[fin] < 1.0).mean():.3f} "
              f"median_err={np.median(err[fin]):.3f}px "
              f"p90={np.percentile(err[fin], 90):.2f}px")


def part2_trace(frames, idw=False, prior=0.0, extra=25, csv=None):
    config = GraphSLAMConfig(
        tracker=TrackerConfig(
            stereo_inverse_depth_weighting=idw,
            motion_prior_translation_info=prior,
            motion_prior_rotation_info=prior,
        ),
        splitting=SplittingConfig(maximum_translation_m=5.0,
                                  maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=5),
        arena_capacity=4096,
        database_capacity=16384,
        max_db_descriptors_per_map=512,
    )
    cam = syn.synthetic_camera()
    slam = GraphSLAM(cam, config, model="stereo")
    acfg = StereoAdaptorConfig()
    rows = []
    for n, fr in enumerate(syn.iter_rendered_loop(count=frames)):
        t0 = time.perf_counter()
        meas = adapt_stereo(jnp.asarray(fr.left), jnp.asarray(fr.right), acfg)
        meas.valid.block_until_ready()
        t1 = time.perf_counter()
        nmaps0, nclo0 = slam.num_maps, slam.num_closures
        slam.process(meas.points, meas.desc, meas.valid, fr.timestamp)
        t2 = time.perf_counter()
        T = slam.robot_in_world()
        dp = np.linalg.norm(T[:3, 3] - fr.gt_pose[:3, 3])
        Rerr = T[:3, :3].T @ fr.gt_pose[:3, :3]
        ang = np.degrees(np.arccos(np.clip((np.trace(Rerr) - 1) / 2, -1, 1)))
        s = slam.last_stats
        rows.append((n, float(t1 - t0), float(t2 - t1),
                     int(s.num_inliers), int(s.num_matches),
                     int(s.matcher_stage), dp, ang,
                     slam.num_maps - nmaps0, slam.num_closures - nclo0,
                     slam.status))
    print(f"\n{'n':>4} {'adapt_ms':>8} {'track_ms':>8} {'inl':>5} {'mat':>5} "
          f"{'stg':>3} {'pos_err':>8} {'yaw_err':>8} split clo status")
    for r in rows:
        if r[0] % 5 == 0 or r[8] or r[9] or r[3] < 20:
            print(f"{r[0]:>4} {r[1]*1e3:>8.1f} {r[2]*1e3:>8.1f} {r[3]:>5} "
                  f"{r[4]:>5} {r[5]:>3} {r[6]:>8.3f} {r[7]:>8.3f} "
                  f"{r[8]:>5} {r[9]:>3} {r[10]}")
    tt = np.array([r[2] for r in rows[5:]])
    ta = np.array([r[1] for r in rows[5:]])
    print(f"\nsteady-state: adapt med={np.median(ta)*1e3:.1f}ms "
          f"p90={np.percentile(ta,90)*1e3:.1f}ms | track "
          f"med={np.median(tt)*1e3:.1f}ms p90={np.percentile(tt,90)*1e3:.1f}ms "
          f"max={tt.max()*1e3:.1f}ms")
    print(f"maps={slam.num_maps} closures={slam.num_closures} "
          f"reloc={slam.num_relocalizations}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", type=int, default=0)
    ap.add_argument("--frames", type=int, default=130)
    ap.add_argument("--idw", action="store_true")
    ap.add_argument("--prior", type=float, default=0.0)
    args = ap.parse_args()
    if args.part in (0, 1):
        part1_stereo_quality()
    if args.part in (0, 2):
        part2_trace(args.frames, idw=args.idw, prior=args.prior)
