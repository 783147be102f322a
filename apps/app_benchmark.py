"""Headless SLAM benchmark harness (reference A2 parity).

Capability parity with the reference benchmark app (reference
srrg2_proslam/apps/app_benchmark.cpp): config-driven pipeline, per-frame
timing, trajectory bookkeeping through local-map estimates, KITTI & TUM
trajectory export, mean_frame_hz dump, and regression gating against the
per-dataset CI thresholds (benchmarks/benchmark_*.cpp:17-21, see
BASELINE.md).

Usage:
  python apps/app_benchmark.py --dataset kitti --sequence <dir> \
      [--gt <poses.txt>] [--count N] [--config <config.json>] \
      [--output traj] [--open-loop]

With no --sequence it runs on the bundled test_data micro-sequence (5
frames) — a fast sanity path.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.io import datasets
from srrg2_proslam_jax.metrics import trajectory as traj_metrics
from srrg2_proslam_jax.models.frontend import (
    DepthAdaptorConfig, StereoAdaptorConfig, adapt_rgbd, adapt_stereo,
)
from srrg2_proslam_jax.models.slam import GraphSLAM, GraphSLAMConfig
from srrg2_proslam_jax.utils import config as cfg
from srrg2_proslam_jax.utils import profiling
from srrg2_proslam_jax.utils.compile_cache import enable_compile_cache

# reference CI regression thresholds (benchmarks/benchmark_*.cpp:17-21);
# "synthetic" is the rendered closed-loop sequence (io/synthetic.py) gated
# at the KITTI thresholds — the only full-sequence regression runnable
# without mounted datasets
REGRESSION_GATES = {
    "kitti": dict(max_mean_t=0.30, max_std_t=1.00),
    "icl": dict(max_mean_t=0.02, max_std_t=0.10),
    "tum": dict(max_mean_t=0.05, max_std_t=0.25),
    "euroc": dict(max_mean_t=0.50, max_std_t=0.50),
    "malaga": dict(max_mean_t=25.0, max_std_t=10.0),
    "synthetic": dict(max_mean_t=0.30, max_std_t=1.00),
    "boss": dict(max_mean_t=0.30, max_std_t=1.00),  # converted KITTI-class
    "boss-rgbd": dict(max_mean_t=0.05, max_std_t=0.25),  # converted TUM-class
}

CAMERAS = {
    "kitti": datasets.kitti_camera,
    "icl": datasets.icl_camera,
    "tum": datasets.tum_camera,
    "euroc": datasets.euroc_camera,
    "malaga": datasets.malaga_camera,
}


def iter_frames(args):
    if args.dataset == "synthetic":
        from srrg2_proslam_jax.io import synthetic as syn

        yield from syn.iter_rendered_loop(count=args.count)
    elif args.sequence is None:
        yield from datasets.iter_bundled_kitti(
            os.path.join(os.path.dirname(__file__), "..", "test_data"), "city"
        )
    elif args.dataset == "kitti":
        yield from datasets.iter_kitti_odometry(args.sequence, args.gt,
                                                count=args.count)
    elif args.dataset in ("tum", "icl"):
        yield from datasets.iter_tum_rgbd(args.sequence, count=args.count)
    elif args.dataset == "euroc":
        yield from datasets.iter_euroc_stereo(args.sequence, count=args.count)
    elif args.dataset == "malaga":
        yield from datasets.iter_malaga_stereo(args.sequence, count=args.count)
    elif args.dataset == "boss":
        from srrg2_proslam_jax.io import boss

        yield from boss.iter_boss_stereo(
            args.sequence, count=args.count,
            left_topic=args.left_topic, right_topic=args.right_topic)
    elif args.dataset == "boss-rgbd":
        from srrg2_proslam_jax.io import boss

        yield from boss.iter_boss_rgbd(
            args.sequence, count=args.count,
            rgb_topic=args.left_topic, depth_topic=args.right_topic)
    else:
        raise SystemExit(f"unsupported dataset {args.dataset}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="kitti",
                    choices=sorted(CAMERAS) + ["synthetic", "boss",
                                               "boss-rgbd"])
    ap.add_argument("--sequence", default=None, help="dataset folder")
    ap.add_argument("--gt", default=None, help="ground-truth pose file")
    ap.add_argument("--count", type=int, default=None)
    ap.add_argument("--config", default=None,
                    help="pipeline config JSON (see configurations/)")
    ap.add_argument("--left-topic", default=None,
                    help="BOSS log left ImageMessage topic (overrides the "
                         "left/right substring heuristic; the reference "
                         "wires topics explicitly, kitti.conf:617-745)")
    ap.add_argument("--right-topic", default=None,
                    help="BOSS log right ImageMessage topic")
    ap.add_argument("--adaptor-config", default=None,
                    help="adaptor config JSON (see configurations/)")
    ap.add_argument("--output", default=None, help="trajectory file prefix")
    ap.add_argument("--chunked", type=int, default=0, metavar="B",
                    help="process the sequence B frames per device program "
                         "(models/chunk.py: adaptor, tracker and status "
                         "machine on device — the production mode on "
                         "high-latency links)")
    ap.add_argument("--open-loop", action="store_true",
                    help="disable loop closing (CI benchmark mode, "
                         "benchmark_kitti.cpp:50-53)")
    ap.add_argument("--profile", action="store_true",
                    help="per-stage scoped timers (Profiler::enable_logging "
                         "analog, benchmark_kitti.cpp:27)")
    ap.add_argument("--trace-dir", default=None,
                    help="capture a jax.profiler device trace into this dir")
    ap.add_argument("--viewer-port", type=int, default=None,
                    help="serve a live top-down map/trajectory view on this "
                         "port (srrg2_proslam_jax.viz.LiveViewer — the "
                         "example_slam_3d.cpp viewer analog; 0 = any port)")
    ap.add_argument("--viewer-every", type=int, default=25,
                    help="refresh the live view every N frames")
    args = ap.parse_args()
    enable_compile_cache()

    viewer = None
    if args.viewer_port is not None:
        from srrg2_proslam_jax.viz import LiveViewer

        viewer = LiveViewer(port=args.viewer_port)

    if args.profile:
        profiling.enable()

    rgbd = args.dataset in ("tum", "icl", "boss-rgbd")
    slam_config = (cfg.load(args.config) if args.config
                   else GraphSLAMConfig())
    if args.open_loop:
        slam_config = cfg.replace(slam_config, enable_loop_closing=False)
    if args.dataset == "euroc" and args.sequence is not None:
        # camera-info-driven initialization (reference
        # apps/app_benchmark.cpp:56-74): the cam-in-body extrinsic of the
        # RECTIFIED camera feeds the tracker's sensor offset
        from srrg2_proslam_jax.io.rectify import find_euroc_rectification

        rect = find_euroc_rectification(args.sequence)
        if rect is not None and rect.T_B_rect is not None:
            tracker = cfg.replace(
                slam_config.tracker,
                T_robot_sensor=tuple(
                    np.asarray(rect.T_B_rect, np.float32).ravel().tolist()),
            )
            slam_config = cfg.replace(slam_config, tracker=tracker)

    frames = iter_frames(args)
    first = next(iter(frames))
    if rgbd:
        if args.dataset == "boss-rgbd":
            from srrg2_proslam_jax.io import boss

            cam = boss.boss_camera(args.sequence)
            if cam is None:
                raise SystemExit("no CameraInfoMessage in the BOSS log")
            if cam.rows == 0:
                cam = cam._replace(rows=first.intensity.shape[0],
                                   cols=first.intensity.shape[1])
        else:
            cam = CAMERAS[args.dataset]()
        adaptor = (cfg.load(args.adaptor_config) if args.adaptor_config
                   else DepthAdaptorConfig())
    else:
        if args.dataset == "synthetic":
            from srrg2_proslam_jax.io import synthetic as syn

            cam = syn.synthetic_camera(*first.left.shape)
        elif args.dataset == "kitti":
            cam = datasets.kitti_camera(*first.left.shape)
        elif args.dataset == "euroc" and args.sequence is not None:
            # iter_euroc_stereo rectifies by default: pair its frames with
            # the matching RECTIFIED pinhole model, not the raw cam0
            # intrinsics (round-2 advisor finding: ~9 px principal-point
            # error otherwise)
            cam = datasets.euroc_rectified_camera(args.sequence)
        elif args.dataset == "boss":
            # camera-info-driven initialization from the log itself
            # (InitializerStereoCamera3D analog, app_benchmark.cpp:56-74)
            from srrg2_proslam_jax.io import boss

            cam = boss.boss_camera(args.sequence)
            if cam is None:
                raise SystemExit("no CameraInfoMessage in the BOSS log")
            if cam.rows == 0:
                cam = cam._replace(rows=first.left.shape[0],
                                   cols=first.left.shape[1])
        else:
            cam = CAMERAS[args.dataset]()
        adaptor = (cfg.load(args.adaptor_config) if args.adaptor_config
                   else StereoAdaptorConfig())

    if args.chunked:
        slam_config = cfg.replace(slam_config, chunk_size=args.chunked)
    slam = GraphSLAM(cam, slam_config, model="rgbd" if rgbd else "stereo")

    if args.chunked:
        # collect the sequence and run it B frames per device program
        all_frames = [first] + list(frames)
        if rgbd:
            a = np.stack([fr.intensity for fr in all_frames])
            b = np.stack([fr.depth for fr in all_frames])
        else:
            a = np.stack([fr.left for fr in all_frames])
            b = np.stack([fr.right for fr in all_frames])
        ts = [fr.timestamp for fr in all_frames]
        gt_poses = [fr.gt_pose for fr in all_frames
                    if fr.gt_pose is not None]
        t0 = time.perf_counter()
        slam.process_sequence(a, b, ts, adaptor)
        compute_time = time.perf_counter() - t0
        n = len(all_frames)
        if viewer is not None:
            viewer.update(slam)
        _finish(args, slam, n, compute_time, gt_poses)
        return

    gt_poses = []
    compute_time = 0.0
    n = 0

    def handle(fr):
        nonlocal compute_time, n
        t0 = time.perf_counter()
        with profiling.profile_time("adaptor"):
            if rgbd:
                meas = adapt_rgbd(jnp.asarray(fr.intensity),
                                  jnp.asarray(fr.depth), adaptor)
            else:
                meas = adapt_stereo(jnp.asarray(fr.left),
                                    jnp.asarray(fr.right), adaptor)
        slam.process(meas.points, meas.desc, meas.valid, fr.timestamp)
        compute_time += time.perf_counter() - t0
        if fr.gt_pose is not None:
            gt_poses.append(fr.gt_pose)
        n += 1
        if viewer is not None and n % args.viewer_every == 0:
            viewer.update(slam)
        if n % 100 == 0:
            T = slam.robot_in_world()
            print(f"frame {n}: maps={slam.num_maps} closures="
                  f"{slam.num_closures} t={T[:3, 3].round(2)}")

    if args.trace_dir:
        with profiling.device_trace(args.trace_dir):
            handle(first)
            for fr in frames:
                handle(fr)
    else:
        handle(first)
        for fr in frames:
            handle(fr)

    _finish(args, slam, n, compute_time, gt_poses)


def _finish(args, slam, n, compute_time, gt_poses):
    # mean_frame_hz definition: msgs / summed compute time
    # (app_benchmark.cpp:350-366)
    hz = n / max(compute_time, 1e-9)
    print(f"processed {n} frames, mean_frame_hz={hz:.2f}")
    if args.profile:
        print(profiling.report())

    est = slam.trajectory()
    if args.output:
        datasets.write_kitti_trajectory(args.output + "_kitti.txt", est)
        datasets.write_tum_trajectory(args.output + "_tum.txt",
                                      slam.timestamps(), est)
        print(f"trajectories written to {args.output}_{{kitti,tum}}.txt")

    if len(gt_poses) == len(est) and len(est) > 1:
        err = traj_metrics.evaluate(est, gt_poses)
        gates = REGRESSION_GATES[args.dataset]
        regression = traj_metrics.is_regression(err, **gates)
        print(json.dumps({
            "mean_translation_rmse": err.mean_translation_rmse.tolist(),
            "std_translation_rmse": err.std_translation_rmse.tolist(),
            "mean_rotation_deg": err.mean_rotation_deg,
            "ate_rmse": err.ate_rmse,
            "mean_frame_hz": hz,
            "regression": bool(regression),
        }))
        sys.exit(1 if regression else 0)


if __name__ == "__main__":
    main()
