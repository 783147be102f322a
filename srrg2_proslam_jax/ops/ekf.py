"""Per-landmark EKF filters, vmapped over the whole map.

Capability parity with the reference point EKFs (PointEKFBase predict/
correct, reference srrg2_proslam/src/srrg2_proslam/mapping/landmarks/
filters/point_ekf_base.hpp:63-125) and the three measurement models:
  * ProjectivePointEKF3D    (3-state, 2-meas: u, v)
  * ProjectiveDepthPointEKF3D (3-state, 3-meas: u, v, depth)
  * StereoProjectivePointEKF3D (3-state, 4-meas: uL, vL, uR, vR with
    baseline; stereo_projective_point_ekf_impl.cpp:12-48)
plus the acceptance gates of LandmarkEstimatorEKF_
(landmark_estimator_ekf_impl.cpp:17-82): minimum per-element covariance,
covariance-norm bound, geometric-jump rejection.

The reference updates landmarks serially in double precision; here a single
f32 ``vmap`` updates every landmark in parallel (SURVEY.md §3.4
accelerator mapping), with the same gating semantics expressed as masks.  f32 is
adequate: innovation matrices are <= 4x4 with pixel-scale entries.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import config as cfg
from . import se3
from .pinhole import Camera


@cfg.register
class LandmarkEKFConfig:
    """Mirrors LandmarkEstimatorEKF3D params (kitti.conf:3-17)."""

    maximum_covariance_norm_squared: float = 0.25
    maximum_distance_geometry_m2: float = 25.0
    minimum_state_element_covariance: float = 0.01
    measurement_noise_px2: float = 1.0  # diagonal measurement covariance


class EKFResult(NamedTuple):
    position: jnp.ndarray    # [M, 3] updated world/local-map positions
    covariance: jnp.ndarray  # [M, 3, 3]
    accepted: jnp.ndarray    # [M] bool — update applied (inlier)


def _measurement_model_projective(p_s, cam: Camera):
    x, y, z = p_s[0], p_s[1], p_s[2]
    iz = 1.0 / jnp.maximum(z, 1e-3)
    iz2 = iz * iz
    h = jnp.array([cam.fx * x * iz + cam.cx, cam.fy * y * iz + cam.cy])
    H = jnp.array(
        [
            [cam.fx * iz, 0.0, -cam.fx * x * iz2],
            [0.0, cam.fy * iz, -cam.fy * y * iz2],
        ]
    )
    return h, H


def _measurement_model_projective_depth(p_s, cam: Camera):
    x, y, z = p_s[0], p_s[1], p_s[2]
    iz = 1.0 / jnp.maximum(z, 1e-3)
    iz2 = iz * iz
    h = jnp.array([cam.fx * x * iz + cam.cx, cam.fy * y * iz + cam.cy, z])
    H = jnp.array(
        [
            [cam.fx * iz, 0.0, -cam.fx * x * iz2],
            [0.0, cam.fy * iz, -cam.fy * y * iz2],
            [0.0, 0.0, 1.0],
        ]
    )
    return h, H


def _measurement_model_stereo(p_s, cam: Camera):
    # (uL, vL, uR, vR) with b_y = 0 (rectified), cf. the reference stereo
    # EKF jacobian (stereo_projective_point_ekf_impl.cpp:42-48).
    x, y, z = p_s[0], p_s[1], p_s[2]
    iz = 1.0 / jnp.maximum(z, 1e-3)
    iz2 = iz * iz
    fx_x = cam.fx * x
    fy_y = cam.fy * y
    h = jnp.array(
        [
            fx_x * iz + cam.cx,
            fy_y * iz + cam.cy,
            (fx_x - cam.baseline_px) * iz + cam.cx,
            fy_y * iz + cam.cy,
        ]
    )
    H = jnp.array(
        [
            [cam.fx * iz, 0.0, -fx_x * iz2],
            [0.0, cam.fy * iz, -fy_y * iz2],
            [cam.fx * iz, 0.0, -(fx_x - cam.baseline_px) * iz2],
            [0.0, cam.fy * iz, -fy_y * iz2],
        ]
    )
    return h, H


_MODELS = {
    "projective": (_measurement_model_projective, 2),
    "projective_depth": (_measurement_model_projective_depth, 3),
    "stereo": (_measurement_model_stereo, 4),
}


def _single_update(p_w, P_w, z, valid, T_ws, cam: Camera, model: str,
                   config: LandmarkEKFConfig):
    """EKF predict/correct for one landmark; returns (p', P', accepted)."""
    model_fn, meas_dim = _MODELS[model]
    R_ws = T_ws[:3, :3]
    # predict: transform state into sensor frame (process noise = 0, the
    # reference adds world_in_sensor_covariance which the pipeline leaves 0)
    p_s = R_ws @ p_w + T_ws[:3, 3]
    P_s = R_ws @ P_w @ R_ws.T
    # Sequential scalar Kalman updates: with diagonal measurement noise the
    # batch update factors into ``meas_dim`` rank-1 updates with scalar
    # innovation variances — no matrix solve/inverse at all.  This matters:
    # the stereo innovation matrix has near-duplicate rows (vL == vR) and
    # XLA's batched f32 solve/inv loses enough digits on it to diverge the
    # filter; the scalar form is unconditionally stable and purely elementwise.
    #
    # The update is ITERATED (Gauss-Newton IEKF, 2 relinearizations): a
    # single EKF sweep linearized at a far-off prediction writes that
    # linearization error into the posterior covariance's correlation
    # structure, and the NEXT frame's (correct) update then confidently
    # drags the state away from the truth — observed as a zero-noise
    # divergence in the statistical tier tests.  Relinearizing about the
    # updated state before committing the covariance removes it; both
    # sweeps are the same elementwise math, vmapped over the arena.
    r_noise = config.measurement_noise_px2

    def sweep(x_lin):
        """One sequential-scalar sweep of the iterated update.

        Linearize h at ``x_lin``; the effective innovation re-centers the
        measurement on the prediction point p_s (IEKF form:
        z - h(x_lin) - H (p_s - x_lin)).
        """
        h, H = model_fn(x_lin, cam)
        innov0 = z - h - H @ (p_s - x_lin)

        def row_update(j, carry):
            dx, P = carry
            Hj = H[j]                      # [3]
            y = innov0[j] - Hj @ dx        # residual of the linearized system
            PH = P @ Hj                    # [3]
            s = r_noise + Hj @ PH
            k = PH / s                     # [3] scalar-gain Kalman column
            dx = dx + k * y
            P = P - jnp.outer(k, PH)
            return dx, P

        return jax.lax.fori_loop(0, meas_dim, row_update,
                                 (jnp.zeros(3), P_s))

    dx1, _ = sweep(p_s)
    dx, P_s_new = sweep(p_s + dx1)
    p_s_new = p_s + dx
    # gates (landmark_estimator_ekf_impl.cpp): behind-camera, covariance
    # norm, geometric jump
    jump2 = jnp.sum((p_s_new - p_s) ** 2)
    ok = (
        valid
        & (p_s_new[2] > 0.0)
        & (jnp.sum(P_s_new * P_s_new) <= config.maximum_covariance_norm_squared)
        & (jump2 <= config.maximum_distance_geometry_m2)
        & jnp.all(jnp.isfinite(p_s_new))
    )
    # back into world frame; enforce covariance floor
    Rt = R_ws.T
    p_w_new = Rt @ (p_s_new - T_ws[:3, 3])
    P_w_new = Rt @ P_s_new @ R_ws
    floor = config.minimum_state_element_covariance
    diag = jnp.diagonal(P_w_new)
    P_w_new = P_w_new + jnp.diag(jnp.maximum(floor - diag, 0.0))
    p_out = jnp.where(ok, p_w_new, p_w)
    P_out = jnp.where(ok, P_w_new, P_w)
    return p_out, P_out, ok


def ekf_update_batch(
    positions: jnp.ndarray,
    covariances: jnp.ndarray,
    measurements: jnp.ndarray,
    valid: jnp.ndarray,
    T_world_in_sensor: jnp.ndarray,
    cam: Camera,
    model: str,
    config: LandmarkEKFConfig,
) -> EKFResult:
    """Vmapped EKF update of M landmarks against row-aligned measurements.

    positions/covariances: [M, 3], [M, 3, 3] in the world (local-map) frame;
    measurements: [M, D] per-model measurement rows; valid: [M] bool marks
    rows that actually observed the landmark this frame.
    """
    upd = jax.vmap(
        _single_update, in_axes=(0, 0, 0, 0, None, None, None, None)
    )
    p, P, ok = upd(positions, covariances, measurements, valid,
                   T_world_in_sensor, cam, model, config)
    return EKFResult(position=p, covariance=P, accepted=ok)


def initial_covariance(depth: jnp.ndarray, cam: Camera,
                       base_px2: float = 1.0) -> jnp.ndarray:
    """Depth-scaled isotropic initial covariance for new landmarks [M, 3, 3].

    Stereo depth error grows with z^2/(f b); a cheap faithful surrogate of
    the reference's landmark statistics initialization
    (merger_projective_impl.cpp:310-328).
    """
    sigma_uv = jnp.sqrt(base_px2) * depth / cam.fx
    sigma_z = jnp.sqrt(base_px2) * depth * depth / jnp.maximum(cam.baseline_px, 1.0)
    var = jnp.stack([sigma_uv**2, sigma_uv**2, sigma_z**2], axis=-1)
    var = jnp.maximum(var, 0.01)
    return jax.vmap(jnp.diag)(var)
