"""End-to-end SLAM on the rendered closed-loop sequence (VERDICT r1 item 1).

Drives the FULL pipeline — frontend, epipolar matching, tracker, splits,
loop closure, relocalization, PGO — over rendered stereo images against
exact GT, and reports per-axis RMSE + closure stats.

Usage: python scripts/rendered_e2e.py [--frames N] [--idw] [--prior]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.io import synthetic as syn
from srrg2_proslam_jax.metrics import trajectory as tm
from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig, adapt_stereo
from srrg2_proslam_jax.models.loop_closure import LoopDetectorConfig
from srrg2_proslam_jax.models.slam import (
    GraphSLAM, GraphSLAMConfig, SplittingConfig,
)
from srrg2_proslam_jax.models.tracker import TrackerConfig
from srrg2_proslam_jax.utils import config as cfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--idw", action="store_true",
                    help="enable stereo inverse-depth weighting")
    ap.add_argument("--prior", type=float, default=0.0,
                    help="motion-prior info (m^-2 / rad^-2)")
    ap.add_argument("--local-ba", action="store_true")
    ap.add_argument("--open-loop", action="store_true")
    ap.add_argument("--side-a", type=float, default=20.0)
    ap.add_argument("--side-b", type=float, default=10.0)
    ap.add_argument("--step", type=float, default=0.35)
    ap.add_argument("--turn-frames", type=int, default=14)
    args = ap.parse_args()

    config = GraphSLAMConfig(
        tracker=TrackerConfig(
            stereo_inverse_depth_weighting=args.idw,
            motion_prior_translation_info=args.prior,
            motion_prior_rotation_info=args.prior,
        ),
        splitting=SplittingConfig(maximum_translation_m=5.0,
                                  maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=5),
        arena_capacity=4096,
        database_capacity=16384,
        max_db_descriptors_per_map=512,
        enable_loop_closing=not args.open_loop,
    )
    if args.local_ba:
        config = cfg.replace(
            config, local_ba=cfg.replace(config.local_ba, enabled=True))

    cam = syn.synthetic_camera()
    slam = GraphSLAM(cam, config, model="stereo")
    acfg = StereoAdaptorConfig()

    gt, est_ts = [], []
    t_adapt = t_track = 0.0
    n = 0
    t_start = time.perf_counter()
    for fr in syn.iter_rendered_loop(count=args.frames, side_a=args.side_a,
                                     side_b=args.side_b, step_m=args.step,
                                     turn_frames=args.turn_frames):
        t0 = time.perf_counter()
        meas = adapt_stereo(jnp.asarray(fr.left), jnp.asarray(fr.right), acfg)
        meas.valid.block_until_ready()
        t1 = time.perf_counter()
        slam.process(meas.points, meas.desc, meas.valid, fr.timestamp)
        t2 = time.perf_counter()
        t_adapt += t1 - t0
        t_track += t2 - t1
        gt.append(fr.gt_pose)
        n += 1
        if n % 50 == 0:
            T = slam.robot_in_world()
            e = np.linalg.norm(T[:3, 3] - fr.gt_pose[:3, 3])
            print(f"frame {n}: maps={slam.num_maps} closures="
                  f"{slam.num_closures} reloc={slam.num_relocalizations} "
                  f"inliers={int(slam.last_stats.num_inliers)} "
                  f"pos_err={e:.3f}m", flush=True)

    wall = time.perf_counter() - t_start
    traj = slam.trajectory()
    err = tm.evaluate(traj, gt)
    final_err = np.linalg.norm(traj[-1][:3, 3] - gt[-1][:3, 3])
    print(f"\nframes={n} wall={wall:.1f}s adapt={t_adapt:.1f}s "
          f"track={t_track:.1f}s hz={n / (t_adapt + t_track):.2f}")
    print(f"maps={slam.num_maps} closures={slam.num_closures} "
          f"relocalizations={slam.num_relocalizations} "
          f"evictions={slam.num_db_evictions}")
    print(f"mean_t_rmse={np.asarray(err.mean_translation_rmse).round(3)} "
          f"std_t_rmse={np.asarray(err.std_translation_rmse).round(3)} "
          f"rot_deg={err.mean_rotation_deg:.2f} ate={err.ate_rmse:.3f} "
          f"final_err={final_err:.3f}")
    gates_ok = bool(np.all(np.asarray(err.mean_translation_rmse) <= 0.30)
                    and err.mean_rotation_deg <= 3.0)
    print(f"KITTI-gates: {'PASS' if gates_ok else 'FAIL'}")


if __name__ == "__main__":
    main()
