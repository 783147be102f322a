"""Dataset converter: raw dataset folders -> packed frame cache (A4 parity).

Capability parity with the reference converters
(reference srrg2_proslam/apps/convert_stereo_to_srrg2.cpp and
convert_rgbd_to_srrg2.cpp, which serialize raw image folders into BOSS
``messages.json`` logs) — redesigned for the device feed: frames are decoded
once (native decoder + prefetcher when built) and packed into a single
uncompressed .npz of uint8/uint16 arrays that mmap-loads at full disk
bandwidth, skipping per-frame PNG decode on every benchmark run.

Usage:
  python apps/convert_dataset.py --dataset kitti --sequence <dir> \
      [--gt poses.txt] [--count N] --output frames.npz
  python apps/convert_dataset.py --dataset tum --sequence <dir> --output out.npz
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from srrg2_proslam_jax.io import datasets


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True,
                    choices=["kitti", "tum", "icl", "euroc", "malaga"])
    ap.add_argument("--sequence", required=True)
    ap.add_argument("--gt", default=None)
    ap.add_argument("--count", type=int, default=None)
    ap.add_argument("--output", required=True)
    ap.add_argument("--format", default="npz", choices=["npz", "boss"],
                    help="npz = packed frame cache; boss = reference-style "
                         "BOSS messages.json log (stereo only)")
    args = ap.parse_args()

    rgbd = args.dataset in ("tum", "icl")
    if args.format == "boss":
        if rgbd:
            raise SystemExit("BOSS export currently supports stereo only")
        from srrg2_proslam_jax.io import boss

        if args.dataset == "kitti":
            frames = datasets.iter_kitti_odometry(args.sequence, args.gt,
                                                  count=args.count)
            # probe the first frame for the image size
            frames = list(frames)
            cam = datasets.kitti_camera(*frames[0].left.shape)
        elif args.dataset == "euroc":
            frames = list(datasets.iter_euroc_stereo(args.sequence,
                                                     count=args.count))
            cam = datasets.euroc_rectified_camera(args.sequence)
        else:
            frames = list(datasets.iter_malaga_stereo(args.sequence,
                                                      count=args.count))
            cam = datasets.malaga_camera()
        n = boss.write_boss_stereo(args.output, frames, cam)
        print(f"wrote {n} BOSS message triplets to {args.output}")
        return

    if args.dataset == "kitti":
        frames = datasets.iter_kitti_odometry(args.sequence, args.gt,
                                              count=args.count)
    elif rgbd:
        frames = datasets.iter_tum_rgbd(args.sequence, count=args.count)
    elif args.dataset == "euroc":
        frames = datasets.iter_euroc_stereo(args.sequence, count=args.count)
    else:
        frames = datasets.iter_malaga_stereo(args.sequence, count=args.count)

    stamps, a_imgs, b_imgs, gts = [], [], [], []
    for fr in frames:
        stamps.append(fr.timestamp)
        if rgbd:
            a_imgs.append(fr.intensity.astype(np.uint8))
            b_imgs.append(fr.depth.astype(np.uint16))
        else:
            a_imgs.append(fr.left.astype(np.uint8))
            b_imgs.append(fr.right.astype(np.uint8))
        if fr.gt_pose is not None:
            gts.append(fr.gt_pose)
        if len(stamps) % 200 == 0:
            print(f"converted {len(stamps)} frames")

    out = {
        "dataset": np.frombuffer(args.dataset.encode(), np.uint8),
        "rgbd": np.asarray(rgbd),
        "timestamps": np.asarray(stamps, np.float64),
        "images_a": np.stack(a_imgs),
        "images_b": np.stack(b_imgs),
    }
    if gts and len(gts) == len(stamps):
        out["gt_poses"] = np.stack(gts).astype(np.float32)
    # record the camera model the cached pixels are in: the EuRoC reader
    # rectifies by default, so the cache must carry the RECTIFIED pinhole
    # (and the body-from-rectified-camera extrinsic), not raw cam0
    # intrinsics (round-2 advisor finding)
    if args.dataset == "euroc":
        from srrg2_proslam_jax.io.rectify import find_euroc_rectification

        rect = find_euroc_rectification(args.sequence)
        if rect is not None:
            c = rect.camera
            out["camera"] = np.asarray(
                [c.fx, c.fy, c.cx, c.cy, c.rows, c.cols, c.baseline_px,
                 c.range_min, c.range_max], np.float64)
            if rect.T_B_rect is not None:
                out["T_robot_sensor"] = np.asarray(rect.T_B_rect, np.float32)
    np.savez(args.output, **out)
    print(f"wrote {len(stamps)} frames to {args.output} "
          f"({os.path.getsize(args.output) / 1e6:.1f} MB)")


def packed_camera(path):
    """Camera model recorded in a converted cache (None when absent).

    Returns (Camera, T_robot_sensor or None)."""
    from srrg2_proslam_jax.ops.pinhole import Camera

    data = np.load(path, mmap_mode="r")
    if "camera" not in data:
        return None, None
    c = np.asarray(data["camera"], np.float64)
    cam = Camera(fx=float(c[0]), fy=float(c[1]), cx=float(c[2]),
                 cy=float(c[3]), rows=int(c[4]), cols=int(c[5]),
                 baseline_px=float(c[6]), range_min=float(c[7]),
                 range_max=float(c[8]))
    T = (np.asarray(data["T_robot_sensor"], np.float32)
         if "T_robot_sensor" in data else None)
    return cam, T


def iter_packed(path):
    """Read a converted cache back as StereoFrame/RGBDFrame objects."""
    data = np.load(path, mmap_mode="r")
    rgbd = bool(data["rgbd"])
    gt = data["gt_poses"] if "gt_poses" in data else None
    for i, ts in enumerate(data["timestamps"]):
        if rgbd:
            yield datasets.RGBDFrame(
                timestamp=float(ts),
                intensity=np.asarray(data["images_a"][i], np.float32),
                depth=np.asarray(data["images_b"][i], np.float32),
                gt_pose=gt[i] if gt is not None else None,
            )
        else:
            yield datasets.StereoFrame(
                timestamp=float(ts),
                left=np.asarray(data["images_a"][i], np.float32),
                right=np.asarray(data["images_b"][i], np.float32),
                gt_pose=gt[i] if gt is not None else None,
            )


if __name__ == "__main__":
    main()
