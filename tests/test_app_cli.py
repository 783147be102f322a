"""CLI-level drive of the benchmark harness on BOSS BLOB logs (VERDICT r4
item 9): the moment a reference-converted dataset is mounted, the exact
``app_benchmark --dataset boss/boss-rgbd`` invocation must run without a
code change — so both paths are exercised end-to-end through ``main()``
here, from a synthetic log with binary BLOB payloads, producing KITTI/TUM
trajectory exports.  Mirrors the reference benchmark flow
(srrg2_proslam/benchmarks/benchmark_kitti.cpp:56-87) at smoke scale.
"""
import dataclasses
import os
import runpy
import sys

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

from srrg2_proslam_jax.io import boss, datasets


def _run_main(argv):
    old = sys.argv
    sys.argv = ["app_benchmark.py"] + argv
    try:
        runpy.run_path(os.path.join(ROOT, "apps", "app_benchmark.py"),
                       run_name="__main__")
    finally:
        sys.argv = old


def test_cli_boss_stereo_blob(tmp_path, capsys):
    frames = [dataclasses.replace(fr, gt_pose=None) for fr in
              datasets.iter_bundled_kitti(
                  os.path.join(ROOT, "test_data"), "city")]
    cam = datasets.kitti_camera(*frames[0].left.shape)
    log = os.path.join(tmp_path, "messages.json")
    boss.write_boss_stereo(log, frames, cam, image_format="blob")
    out = os.path.join(tmp_path, "traj")
    _run_main(["--dataset", "boss", "--sequence", log,
               "--output", out,
               "--left-topic", "/camera_left/image_raw",
               "--right-topic", "/camera_right/image_raw"])
    text = capsys.readouterr().out
    assert f"processed {len(frames)} frames" in text
    rows = np.loadtxt(out + "_kitti.txt").reshape(-1, 12)
    assert rows.shape[0] == len(frames)
    # the 5-frame city VO must actually move forward (sanity, not a gate)
    assert rows[-1].reshape(3, 4)[2, 3] > 0.5


def test_cli_boss_rgbd_blob(tmp_path, capsys):
    frames = list(datasets.iter_bundled_icl(os.path.join(ROOT, "test_data")))
    cam = datasets.icl_camera()
    log = os.path.join(tmp_path, "messages.json")
    n = boss.write_boss_rgbd(log, frames, cam)
    assert n == len(frames)
    out = os.path.join(tmp_path, "traj")
    _run_main(["--dataset", "boss-rgbd", "--sequence", log,
               "--output", out])
    text = capsys.readouterr().out
    assert f"processed {len(frames)} frames" in text
    assert os.path.exists(out + "_tum.txt")


def test_boss_rgbd_roundtrip(tmp_path, rng):
    """write_boss_rgbd -> iter_boss_rgbd is bit-exact for intensity (via
    the 3-channel BLOB path) and raw depth (uint16 BLOB path)."""
    cam = datasets.icl_camera()
    frames = [datasets.RGBDFrame(
        timestamp=10.0 + 0.1 * i,
        intensity=rng.randint(0, 255, (32, 40)).astype(np.float32),
        depth=rng.randint(500, 5000, (32, 40)).astype(np.float32),
    ) for i in range(3)]
    log = os.path.join(tmp_path, "messages.json")
    boss.write_boss_rgbd(log, frames, cam)
    got = list(boss.iter_boss_rgbd(log))
    assert len(got) == 3
    for a, b in zip(frames, got):
        # gray -> replicated rgb -> ITU-601 luma is identity up to rounding
        np.testing.assert_allclose(a.intensity, b.intensity, atol=0.51)
        np.testing.assert_array_equal(np.uint16(a.depth), np.uint16(b.depth))
