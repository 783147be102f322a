"""Dataset readers emitting host numpy arrays ready for device upload.

Capability parity with the reference's message/dataset layer (BOSS
``messages.json`` + MessageSortedSource/MessageSynchronizedSource +
converters ``apps/convert_stereo_to_srrg2.cpp`` / ``convert_rgbd_to_srrg2.cpp``,
SURVEY.md F11) — redesigned as plain Python iterators over raw dataset
folders: the synchronization the reference does at message level is done
here by filename/timestamp pairing, and images arrive as float32 numpy
arrays (the device upload boundary of SURVEY.md §3.1).

Supported layouts:
  * bundled micro test data (``test_data/kitti/*``, ``test_data/icl``,
    ``test_data/xtion``, ``test_data/scene_flow``) — same files the
    reference tests use;
  * KITTI odometry folders (``image_0/*.png image_1/*.png times.txt``);
  * TUM RGB-D folders (``rgb.txt depth.txt`` with timestamp pairing);
  * EuRoC ASL folders (``cam0/data cam1/data`` with timestamp pairing);
  * Malaga urban extracts (rectified stereo image pairs).
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..ops.pinhole import Camera


# --------------------------------------------------------------------------
# image loading
# --------------------------------------------------------------------------

def load_gray(path: str) -> np.ndarray:
    """Load an image as float32 grayscale [H, W] in 0..255.

    Prefers the native C++ decoder (io/native.py, built from native/);
    falls back to PIL when the library is not available.
    """
    from . import native

    arr = native.decode(path) if native.available() else None
    if arr is not None:
        return native.to_gray_f32(arr)
    from PIL import Image

    img = Image.open(path)
    if img.mode not in ("L", "I", "I;16"):
        img = img.convert("L")
    arr = np.asarray(img)
    if arr.dtype == np.uint16 or arr.dtype == np.int32:
        arr = (arr / 256).astype(np.float32)
    return np.ascontiguousarray(arr, dtype=np.float32)


def save_gray(path: str, image) -> None:
    """Write a float32/uint8 grayscale [H, W] image (0..255) to disk."""
    arr = np.asarray(image)
    arr = np.clip(arr, 0, 255).astype(np.uint8)
    from PIL import Image

    Image.fromarray(arr, mode="L").save(path)


def load_depth(path: str) -> np.ndarray:
    """Load a 16-bit depth image as float32 raw units [H, W].

    Handles the binary PGMs bundled with the reference test data and
    16UC1 PNGs (TUM/ICL exports). Scaling to meters happens in the adaptor
    (mirrors raw_data_preprocessor_monocular_depth.cpp:121-134).
    """
    from . import native

    arr = native.decode(path) if native.available() else None
    if arr is None:
        from PIL import Image

        arr = np.asarray(Image.open(path))
    if arr.ndim == 3:
        arr = arr[:, :, 0]
    return np.ascontiguousarray(arr, dtype=np.float32)


def read_pfm(path: str) -> np.ndarray:
    """SceneFlow-style PFM disparity/float image (the reference's readPFM,
    compute_sparse_stereo_gt.cpp): 'Pf'/'PF' header, 'W H', scale line
    whose sign encodes endianness, float32 rows stored BOTTOM-UP.
    Returns the first channel, top-down, [H, W] float32."""
    import re

    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").strip()
        if header not in ("Pf", "PF"):
            raise ValueError(f"not a PFM file: {path} (header {header!r})")
        dims = f.readline().decode("latin-1").strip()
        while dims.startswith("#"):
            dims = f.readline().decode("latin-1").strip()
        w, h = map(int, re.split(r"\s+", dims))
        scale = float(f.readline().decode("latin-1").strip())
        count = w * h * (3 if header == "PF" else 1)
        data = np.frombuffer(
            f.read(count * 4), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, -1)[..., 0]
    return np.ascontiguousarray(img[::-1]).astype(np.float32)


def write_pfm(path: str, image: np.ndarray) -> None:
    """Write a [H, W] float32 image as little-endian grayscale PFM."""
    arr = np.asarray(image, np.float32)
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{arr.shape[1]} {arr.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(arr[::-1]).astype("<f4").tobytes())


# --------------------------------------------------------------------------
# calibrations (values the reference fixtures/configs pin for these datasets)
# --------------------------------------------------------------------------

def kitti_camera(rows: int = 376, cols: int = 1241) -> Camera:
    """KITTI odometry seq-00 rectified intrinsics (fixtures.hpp:810-811)."""
    return Camera(fx=718.856, fy=718.856, cx=607.193, cy=185.216,
                  rows=rows, cols=cols, baseline_px=386.1448,
                  range_min=0.1, range_max=300.0)


def icl_camera() -> Camera:
    """ICL-NUIM intrinsics (fixtures.hpp:577; note the negated fy)."""
    return Camera(fx=481.2, fy=-481.0, cx=319.5, cy=239.5,
                  rows=480, cols=640, range_min=0.1, range_max=20.0)


def tum_camera() -> Camera:
    """TUM RGB-D (freiburg1) default pinhole intrinsics."""
    return Camera(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                  rows=480, cols=640, range_min=0.1, range_max=20.0)


def euroc_camera() -> Camera:
    """EuRoC MAV cam0 intrinsics (rectified model)."""
    return Camera(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                  rows=480, cols=752, baseline_px=458.654 * 0.11,
                  range_min=0.1, range_max=100.0)


def malaga_camera() -> Camera:
    """Malaga urban dataset rectified stereo intrinsics (800x600 bumblebee)."""
    return Camera(fx=795.11588, fy=795.11588, cx=517.12973, cy=395.59665,
                  rows=768, cols=1024, baseline_px=795.11588 * 0.119571,
                  range_min=0.1, range_max=300.0)


# --------------------------------------------------------------------------
# frames
# --------------------------------------------------------------------------

@dataclass
class StereoFrame:
    timestamp: float
    left: np.ndarray
    right: np.ndarray
    gt_pose: Optional[np.ndarray] = None  # 4x4, world_from_camera


@dataclass
class RGBDFrame:
    timestamp: float
    intensity: np.ndarray
    depth: np.ndarray   # raw units; adaptor applies depth_scale
    gt_pose: Optional[np.ndarray] = None


def _kitti_pose_lines(path: str) -> np.ndarray:
    """KITTI gt format: rows of 12 floats = row-major 3x4 [R|t]."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4, dtype=np.float64), (data.shape[0], 1, 1))
    out[:, :3, :] = data
    return out.astype(np.float32)


def iter_bundled_kitti(root: str, sequence: str = "city") -> Iterator[StereoFrame]:
    """The 5-frame (city) / 2-frame (highway) micro sequences of test_data."""
    folder = os.path.join(root, "kitti", sequence)
    lefts = sorted(
        f for f in os.listdir(folder) if f.startswith("image_left")
    )
    gt = _kitti_pose_lines(os.path.join(folder, "gt.txt"))
    for i, name in enumerate(lefts):
        # gt.txt holds the FULL sequence trajectory; index by the frame id
        # parsed from the filename (highway frames are 274/275, not 0/1)
        frame_id = int(re.findall(r"\d+", name)[0])
        yield StereoFrame(
            timestamp=float(i) * 0.1,
            left=load_gray(os.path.join(folder, name)),
            right=load_gray(os.path.join(folder, f"image_right_{frame_id}.png")),
            gt_pose=gt[frame_id] if frame_id < len(gt) else None,
        )


def iter_bundled_icl(root: str) -> Iterator[RGBDFrame]:
    """The 3 bundled ICL-NUIM frames (ids 0, 1, 50)."""
    folder = os.path.join(root, "icl")
    # GT poses the reference fixture pins for these frames (fixtures.hpp:597-615)
    for i, frame_id in enumerate((0, 1, 50)):
        yield RGBDFrame(
            timestamp=float(i),
            intensity=load_gray(os.path.join(folder, f"image_rgb_{frame_id}.png")),
            depth=load_depth(os.path.join(folder, f"image_depth_{frame_id}.pgm")),
        )


def iter_kitti_odometry(
    sequence_dir: str, gt_file: Optional[str] = None,
    start: int = 0, count: Optional[int] = None,
) -> Iterator[StereoFrame]:
    """Full KITTI odometry sequence folder (image_0/, image_1/, times.txt)."""
    left_dir = os.path.join(sequence_dir, "image_0")
    right_dir = os.path.join(sequence_dir, "image_1")
    names = sorted(os.listdir(left_dir))
    times_path = os.path.join(sequence_dir, "times.txt")
    times = (np.loadtxt(times_path) if os.path.exists(times_path)
             else np.arange(len(names), dtype=np.float64) * 0.1)
    gt = _kitti_pose_lines(gt_file) if gt_file else None
    end = len(names) if count is None else min(len(names), start + count)
    for i in range(start, end):
        yield StereoFrame(
            timestamp=float(times[i]),
            left=load_gray(os.path.join(left_dir, names[i])),
            right=load_gray(os.path.join(right_dir, names[i])),
            gt_pose=gt[i] if gt is not None and i < len(gt) else None,
        )


def iter_tum_rgbd(
    sequence_dir: str, max_dt: float = 0.02, count: Optional[int] = None,
) -> Iterator[RGBDFrame]:
    """TUM RGB-D folder: pairs rgb.txt/depth.txt by nearest timestamp.

    Mirrors the reference's MessageSynchronizedSource 0.01 s window
    (configurations/tum.conf analog of kitti.conf:144-162).
    """

    def read_list(path):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, name = line.split()[:2]
                out.append((float(ts), name))
        return out

    rgb = read_list(os.path.join(sequence_dir, "rgb.txt"))
    depth = read_list(os.path.join(sequence_dir, "depth.txt"))
    d_times = np.array([t for t, _ in depth])
    emitted = 0
    for ts, rgb_name in rgb:
        j = int(np.argmin(np.abs(d_times - ts)))
        if abs(d_times[j] - ts) > max_dt:
            continue
        yield RGBDFrame(
            timestamp=ts,
            intensity=load_gray(os.path.join(sequence_dir, rgb_name)),
            depth=load_depth(os.path.join(sequence_dir, depth[j][1])),
        )
        emitted += 1
        if count is not None and emitted >= count:
            return


def iter_euroc_stereo(
    sequence_dir: str, count: Optional[int] = None, rectify: bool = True,
) -> Iterator[StereoFrame]:
    """EuRoC ASL layout: mav0/cam0/data, mav0/cam1/data (ns timestamps).

    When ``mav0/cam{0,1}/sensor.yaml`` are present (the standard ASL layout)
    the raw radtan-distorted, non-coplanar images are undistorted and
    rectified through io/rectify.py before being emitted — the capability
    the reference gets from its converter pipeline
    (apps/convert_stereo_to_srrg2.cpp + configurations/euroc.conf).  Use
    ``euroc_rectified_camera`` for the matching pinhole model.
    """
    cam0 = os.path.join(sequence_dir, "mav0", "cam0", "data")
    cam1 = os.path.join(sequence_dir, "mav0", "cam1", "data")
    rect = None
    if rectify:
        from .rectify import find_euroc_rectification, remap

        rect = find_euroc_rectification(sequence_dir)
    names0 = sorted(os.listdir(cam0))
    names1 = set(os.listdir(cam1))
    emitted = 0
    for name in names0:
        if name not in names1:
            continue
        ts = float(os.path.splitext(name)[0]) * 1e-9
        left = load_gray(os.path.join(cam0, name))
        right = load_gray(os.path.join(cam1, name))
        if rect is not None:
            left = remap(left, rect.map0)
            right = remap(right, rect.map1)
        yield StereoFrame(timestamp=ts, left=left, right=right)
        emitted += 1
        if count is not None and emitted >= count:
            return


def euroc_rectified_camera(sequence_dir: str) -> Camera:
    """The pinhole model matching ``iter_euroc_stereo(rectify=True)``."""
    from .rectify import find_euroc_rectification

    rect = find_euroc_rectification(sequence_dir)
    return rect.camera if rect is not None else euroc_camera()


def iter_malaga_stereo(
    sequence_dir: str, count: Optional[int] = None,
) -> Iterator[StereoFrame]:
    """Malaga urban dataset extract: ``Images/`` folder of rectified pairs
    named ``img_CAMERA1_<timestamp>_{left,right}.jpg|png``."""
    img_dir = os.path.join(sequence_dir, "Images")
    if not os.path.isdir(img_dir):
        img_dir = sequence_dir
    lefts = sorted(f for f in os.listdir(img_dir) if "_left" in f)
    emitted = 0
    for name in lefts:
        right_name = name.replace("_left", "_right")
        right_path = os.path.join(img_dir, right_name)
        if not os.path.exists(right_path):
            continue
        stamp = re.findall(r"\d+\.\d+", name)
        yield StereoFrame(
            timestamp=float(stamp[0]) if stamp else float(emitted),
            left=load_gray(os.path.join(img_dir, name)),
            right=load_gray(right_path),
        )
        emitted += 1
        if count is not None and emitted >= count:
            return


# --------------------------------------------------------------------------
# trajectory export (A2 parity: app_benchmark.cpp:205-240)
# --------------------------------------------------------------------------

def write_kitti_trajectory(path: str, poses: List[np.ndarray]) -> None:
    """Rows of row-major 3x4 [R|t] — the KITTI benchmark format."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9e}" for v in np.asarray(T)[:3, :].reshape(-1)))
            f.write("\n")


def write_tum_trajectory(path: str, stamps: List[float],
                         poses: List[np.ndarray]) -> None:
    """Rows of ``timestamp tx ty tz qx qy qz qw`` — the TUM format."""
    from .quaternions import rotation_to_quaternion

    with open(path, "w") as f:
        for ts, T in zip(stamps, poses):
            T = np.asarray(T)
            q = rotation_to_quaternion(T[:3, :3])
            t = T[:3, 3]
            f.write(f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
