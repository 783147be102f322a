"""Landmark estimators: weighted running mean and pose-based GN smoother.

Capability parity with the reference's two non-EKF landmark estimators
(the EKF family lives in ops/ekf.py):

  * LandmarkEstimatorWeightedMean_ (reference srrg2_proslam/src/srrg2_proslam/
    mapping/landmarks/landmark_estimator_weighted_mean_impl.cpp:14-40):
    running mean weighted by the optimization count with a geometric-
    divergence gate.
  * LandmarkEstimatorPoseBasedSmoother_ (.../landmark_estimator_pose_based_
    smoother_impl.cpp:6-150): structure-only Gauss-Newton over ALL buffered
    camera measurements of a landmark — reprojection (u, v) + depth residual
    with the depth row up-weighted x10, saturated kernel, mean fallback below
    the minimum measurement count, and inlier-count-based acceptance.

The reference runs both serially per landmark; here both are vmapped over
the whole arena (SURVEY.md §3.4 accelerator mapping).  The smoother's unbounded
per-landmark measurement vector becomes a fixed-capacity ring buffer
(masks, not resizes — SURVEY.md §7.1).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import config as cfg
from .pinhole import Camera


@cfg.register
class WeightedMeanConfig:
    """Mirrors LandmarkEstimatorWeightedMean params."""

    maximum_distance_geometry_m2: float = 25.0


@cfg.register
class SmootherConfig:
    """Mirrors LandmarkEstimatorPoseBasedSmoother params (kitti.conf analog)."""

    maximum_reprojection_error_px2: float = 100.0
    minimum_measurements: int = 3
    iterations: int = 10
    depth_weight: float = 10.0
    maximum_distance_geometry_m2: float = 25.0


class WeightedMeanResult(NamedTuple):
    position: jnp.ndarray   # [M, 3]
    accepted: jnp.ndarray   # [M] bool


def weighted_mean_update_batch(
    positions: jnp.ndarray,      # [M, 3] current landmark states (world frame)
    num_updates: jnp.ndarray,    # [M] int32 optimization counts
    p_world_meas: jnp.ndarray,   # [M, 3] sensor_in_world * landmark_in_sensor
    valid: jnp.ndarray,          # [M] bool — landmark observed this frame
    config: WeightedMeanConfig,
) -> WeightedMeanResult:
    """Vmapless batched weighted-mean update (pure elementwise math).

    new = ((n+1) * old + meas) / (n+2), rejected when the state would jump
    more than the geometric gate (weighted_mean_impl.cpp:22-34).
    """
    w = num_updates.astype(jnp.float32) + 1.0
    proposed = (w[:, None] * positions + p_world_meas) / (w[:, None] + 1.0)
    jump2 = jnp.sum((proposed - positions) ** 2, axis=-1)
    ok = valid & (jump2 <= config.maximum_distance_geometry_m2)
    return WeightedMeanResult(
        position=jnp.where(ok[:, None], proposed, positions),
        accepted=ok,
    )


class MeasurementBuffer(NamedTuple):
    """Fixed-capacity per-landmark camera-measurement ring buffers.

    The fixed-shape replacement of PointStatisticsField3D::CameraMeasurement
    vectors (reference pose_based_smoother_impl.cpp:14-21): slot k of
    landmark m holds the image point, the camera-frame point, and the
    world->camera transform of the observation.
    """

    point_in_image: jnp.ndarray   # [M, K, 2] (u, v)
    point_in_camera: jnp.ndarray  # [M, K, 3] (x, y, z) sensor frame
    T_world_to_cam: jnp.ndarray   # [M, K, 4, 4] world_from_camera of the ref
    count: jnp.ndarray            # [M] int32 total observations (ring index)

    @property
    def capacity(self) -> int:
        return self.point_in_image.shape[1]


def empty_measurement_buffer(num_landmarks: int, capacity: int = 8) -> MeasurementBuffer:
    return MeasurementBuffer(
        point_in_image=jnp.zeros((num_landmarks, capacity, 2), jnp.float32),
        point_in_camera=jnp.zeros((num_landmarks, capacity, 3), jnp.float32),
        T_world_to_cam=jnp.broadcast_to(
            jnp.eye(4, dtype=jnp.float32), (num_landmarks, capacity, 4, 4)
        ),
        count=jnp.zeros((num_landmarks,), jnp.int32),
    )


def add_measurements(
    buf: MeasurementBuffer,
    uv: jnp.ndarray,            # [M, 2]
    p_cam: jnp.ndarray,         # [M, 3]
    T_world_to_cam: jnp.ndarray,  # [4, 4] shared current-frame transform
    observed: jnp.ndarray,      # [M] bool
) -> MeasurementBuffer:
    """Ring-buffer insert of this frame's observations for observed landmarks."""
    K = buf.capacity
    slot = buf.count % K
    one_hot = jax.nn.one_hot(slot, K, dtype=jnp.float32) * observed[:, None]
    keep = 1.0 - one_hot
    return MeasurementBuffer(
        point_in_image=buf.point_in_image * keep[..., None]
        + one_hot[..., None] * uv[:, None, :],
        point_in_camera=buf.point_in_camera * keep[..., None]
        + one_hot[..., None] * p_cam[:, None, :],
        T_world_to_cam=buf.T_world_to_cam * keep[..., None, None]
        + one_hot[..., None, None] * T_world_to_cam[None, None],
        count=buf.count + observed.astype(jnp.int32),
    )


class SmootherResult(NamedTuple):
    position: jnp.ndarray    # [M, 3] world-frame
    accepted: jnp.ndarray    # [M] bool
    num_inliers: jnp.ndarray  # [M] int32


def _mean_world_coordinates(buf_cam, buf_Twc, slot_valid):
    """camera_from_world^-1 applied to the camera point, averaged
    (pose_based_smoother_impl.cpp:_setMeanCoordinatesInWorld)."""
    R = buf_Twc[:, :3, :3]
    t = buf_Twc[:, :3, 3]
    # world point = R^T (p_cam - t)
    p_w = jnp.einsum("kji,kj->ki", R, buf_cam - t)
    w = slot_valid.astype(jnp.float32)
    return jnp.sum(p_w * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1.0)


def _smooth_single(
    p_world, buf_img, buf_cam, buf_Twc, count, num_updates, lm_valid,
    cam: Camera, config: SmootherConfig,
):
    """Structure-only GN for one landmark over its K measurement slots."""
    K = buf_img.shape[0]
    slot_valid = (jnp.arange(K) < count)
    n_meas = jnp.sum(slot_valid)

    omega = jnp.array([1.0, 1.0, config.depth_weight], jnp.float32)

    def residuals(x):
        # p_cam_k = T_wc_k * x  (world_from_camera maps world -> camera,
        # pose_based_smoother_impl.cpp:61)
        p_c = jnp.einsum("kij,j->ki", buf_Twc[:, :3, :3], x) + buf_Twc[:, :3, 3]
        z = p_c[:, 2]
        z_safe = jnp.maximum(z, 1e-3)
        iz = 1.0 / z_safe
        u = cam.fx * p_c[:, 0] * iz + cam.cx
        v = cam.fy * p_c[:, 1] * iz + cam.cy
        r = jnp.stack(
            [u - buf_img[:, 0], v - buf_img[:, 1], z - buf_cam[:, 2]], axis=-1
        )
        ok = slot_valid & (z > 0.0)
        return r, p_c, iz, ok

    def gn_body(_, carry):
        x, _ = carry
        r, p_c, iz, ok = residuals(x)
        chi = jnp.sum(r * r * omega, axis=-1)
        # saturated kernel (impl.cpp:81-85): scale omega beyond the bound
        kw = jnp.minimum(1.0, config.maximum_reprojection_error_px2 /
                         jnp.maximum(chi, 1e-9))
        w = jnp.where(ok, kw, 0.0)
        iz2 = iz * iz
        zero = jnp.zeros_like(iz)
        one = jnp.ones_like(iz)
        # d(projection)/d(p_cam) rows: u, v, z
        Jh = jnp.stack(
            [
                jnp.stack([cam.fx * iz, zero, -cam.fx * p_c[:, 0] * iz2], -1),
                jnp.stack([zero, cam.fy * iz, -cam.fy * p_c[:, 1] * iz2], -1),
                jnp.stack([zero, zero, one], -1),
            ],
            axis=-2,
        )  # [K, 3, 3]
        J = Jh @ buf_Twc[:, :3, :3]  # chain d(p_cam)/dx = R
        Wo = (omega[None, :] * w[:, None])
        H = jnp.einsum("kdi,kd,kdj->ij", J, Wo, J)
        b = jnp.einsum("kdi,kd,kd->i", J, Wo, r)
        dx = -jnp.linalg.solve(H + 1e-6 * jnp.eye(3), b)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros(3))
        inliers = jnp.sum(ok & (chi <= config.maximum_reprojection_error_px2))
        return x + dx, inliers

    x_opt, inliers = jax.lax.fori_loop(
        0, config.iterations, gn_body, (p_world, jnp.int32(0))
    )

    mean_w = _mean_world_coordinates(buf_cam, buf_Twc, slot_valid)
    use_mean = n_meas < config.minimum_measurements
    # acceptance mirrors impl.cpp:120-133: optimized result only if it beats
    # the landmark's optimization count; otherwise fall back to the mean
    accept_opt = (~use_mean) & (inliers > num_updates) & jnp.all(jnp.isfinite(x_opt))
    jump2_mean = jnp.sum((mean_w - p_world) ** 2)
    accept_mean_update = jump2_mean <= config.maximum_distance_geometry_m2
    candidate = jnp.where(accept_opt, x_opt, mean_w)
    accepted = lm_valid & (n_meas > 0) & (
        accept_opt | (use_mean & accept_mean_update) | ~use_mean
    )
    position = jnp.where(accepted, candidate, p_world)
    return position, accepted, inliers


def smoother_update_batch(
    positions: jnp.ndarray,     # [M, 3] world-frame landmark states
    buf: MeasurementBuffer,
    num_updates: jnp.ndarray,   # [M] int32
    lm_valid: jnp.ndarray,      # [M] bool
    cam: Camera,
    config: SmootherConfig,
) -> SmootherResult:
    """Vmapped pose-based smoother over all landmarks."""
    pos, ok, inl = jax.vmap(
        _smooth_single, in_axes=(0, 0, 0, 0, 0, 0, 0, None, None)
    )(positions, buf.point_in_image, buf.point_in_camera, buf.T_world_to_cam,
      buf.count, num_updates, lm_valid, cam, config)
    return SmootherResult(position=pos, accepted=ok, num_inliers=inl)
