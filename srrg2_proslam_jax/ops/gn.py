"""Fused Gauss-Newton pose estimation kernels.

Capability parity with the reference's MultiAligner3DQR + srrg2_solver stack
(SURVEY.md §3.3: per-iteration linearization of SE3 projective/stereo/
point-to-point error factors, GN step with damping, saturated/clamp
robustifiers, 6x6 normal-equation solve) — redesigned as batched residual/
Jacobian evaluation over fixed-capacity correspondence arrays with a psum-
friendly reduction to (H, b).  Only the 6-DoF pose is variable (points are
fixed), so H is 6x6 and the solve happens on-chip in the same jit.

Parametrization: the estimate X maps moving-frame points into the fixed
(sensor) frame, updated by left multiplication X <- exp(dx) X, dx = [v, w].
Jacobian of (exp(dx) X p) wrt dx at dx=0 is [I | -skew(X p)].

Factors:
  * stereo_projective_system — SE3RectifiedStereoProjectiveErrorFactor
    equivalent: residual (uL, vL, uR) of the rectified stereo projection
    (reference factor usage: aligner_slice_processor_projective.h:63-192).
  * projective_depth_system — SE3ProjectiveDepthErrorFactor equivalent:
    residual (u, v, depth).
  * point3_system — point-to-point SE3 factor for loop-closure alignment
    (aligner_slice_processor_3d.hpp:7-24).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from . import se3
from .pinhole import Camera


class GNStats(NamedTuple):
    chi_total: jnp.ndarray    # robust chi sum over inliers
    num_inliers: jnp.ndarray  # correspondences below the robust threshold
    num_terms: jnp.ndarray    # active correspondences


def robust_saturate(chi: jnp.ndarray, chi_threshold: float) -> jnp.ndarray:
    """Saturated kernel weight: w = min(1, threshold/chi).

    Equivalent effect to the reference's RobustifierSaturated policy
    (kitti.conf:130-141, chi_threshold 25): errors beyond the threshold
    contribute a constant cost, i.e. a downscaled quadratic term.
    """
    return jnp.minimum(1.0, chi_threshold / jnp.maximum(chi, 1e-12))


def robust_clamp(chi: jnp.ndarray, chi_threshold: float) -> jnp.ndarray:
    """Clamp kernel: weight 0 beyond the threshold (RobustifierClamp, chi=3)."""
    return (chi <= chi_threshold).astype(jnp.float32)


def _reduce_system(J, r, weights, mask, chi_threshold, kernel):
    """Common (H, b) reduction with per-term robust reweighting.

    J: [C, D, 6], r: [C, D], weights: [C] (info scaling), mask: [C] bool.
    """
    chi = jnp.sum(r * r, axis=-1) * weights
    kw = kernel(chi, chi_threshold)
    w = jnp.where(mask, weights * kw, 0.0)
    H = jnp.einsum("cdi,cdj,c->ij", J, J, w)
    b = jnp.einsum("cdi,cd,c->i", J, r, w)
    inlier = mask & (chi <= chi_threshold)
    stats = GNStats(
        chi_total=jnp.sum(jnp.where(mask, jnp.minimum(chi, chi_threshold), 0.0)),
        num_inliers=jnp.sum(inlier),
        num_terms=jnp.sum(mask),
    )
    return H, b, stats


def stereo_projective_system(
    X: jnp.ndarray,
    pts_moving: jnp.ndarray,
    meas_uvu: jnp.ndarray,
    weights: jnp.ndarray,
    mask: jnp.ndarray,
    cam: Camera,
    chi_threshold: float = 25.0,
    kernel: Callable = robust_saturate,
):
    """Normal equations for rectified-stereo reprojection.

    pts_moving: [C, 3] map points (moving frame); meas_uvu: [C, 3] measured
    (uL, vL, uR).  Residual r = h(X p) - z with
      h = (fx x/z + cx,  fy y/z + cy,  fx x/z + cx - b_px/z).
    """
    p = se3.transform_points(X, pts_moving)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    z_safe = jnp.maximum(z, 1e-3)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    u_l = cam.fx * x * iz + cam.cx
    v_l = cam.fy * y * iz + cam.cy
    u_r = u_l - cam.baseline_px * iz
    r = jnp.stack([u_l, v_l, u_r], axis=-1) - meas_uvu
    # projection jacobian wrt p (camera frame): [C, 3, 3]
    zero = jnp.zeros_like(x)
    Jp = jnp.stack(
        [
            jnp.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
            jnp.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
            jnp.stack([cam.fx * iz, zero, (-cam.fx * x + cam.baseline_px) * iz2], -1),
        ],
        axis=-2,
    )
    # chain with pose perturbation: dp/ddx = [I | -skew(p)]
    Jx = jnp.concatenate([jnp.broadcast_to(jnp.eye(3), Jp.shape), -se3.skew(p)], axis=-1)
    J = Jp @ Jx  # [C, 3, 6]
    mask = mask & (z > cam.range_min)
    return _reduce_system(J, r, weights, mask, chi_threshold, kernel)


def projective_depth_system(
    X: jnp.ndarray,
    pts_moving: jnp.ndarray,
    meas_uvd: jnp.ndarray,
    weights: jnp.ndarray,
    mask: jnp.ndarray,
    cam: Camera,
    chi_threshold: float = 25.0,
    depth_weight: float = 10.0,
    kernel: Callable = robust_saturate,
):
    """Normal equations for pinhole + depth (RGB-D) reprojection.

    meas_uvd: [C, 3] = (u, v, depth_m); the depth row is up-weighted by
    ``depth_weight`` mirroring the reference smoother's depth emphasis
    (landmark_estimator_pose_based_smoother_impl.cpp:55-103).
    """
    p = se3.transform_points(X, pts_moving)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    z_safe = jnp.maximum(z, 1e-3)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    sw = jnp.sqrt(depth_weight)
    r = jnp.stack([u, v, sw * z], -1) - meas_uvd * jnp.array([1.0, 1.0, sw])
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    Jp = jnp.stack(
        [
            jnp.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
            jnp.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
            jnp.stack([zero, zero, sw * one], -1),
        ],
        axis=-2,
    )
    Jx = jnp.concatenate([jnp.broadcast_to(jnp.eye(3), Jp.shape), -se3.skew(p)], axis=-1)
    J = Jp @ Jx
    mask = mask & (z > cam.range_min)
    return _reduce_system(J, r, weights, mask, chi_threshold, kernel)


def point3_system(
    X: jnp.ndarray,
    pts_moving: jnp.ndarray,
    pts_fixed: jnp.ndarray,
    weights: jnp.ndarray,
    mask: jnp.ndarray,
    chi_threshold: float = 3.0,
    kernel: Callable = robust_clamp,
):
    """Normal equations for 3D point-to-point alignment (loop closures)."""
    p = se3.transform_points(X, pts_moving)
    r = p - pts_fixed
    J = jnp.concatenate([jnp.broadcast_to(jnp.eye(3), p.shape + (3,)), -se3.skew(p)], axis=-1)
    return _reduce_system(J, r, weights, mask, chi_threshold, kernel)


def gn_step(X: jnp.ndarray, H: jnp.ndarray, b: jnp.ndarray,
            damping: float = 1e-6) -> jnp.ndarray:
    """One damped GN update X <- exp(-solve(H, b)) X (kitti.conf damping 1e-6)."""
    return gn_step_dx(X, H, b, damping)[0]


def gn_step_dx(X: jnp.ndarray, H: jnp.ndarray, b: jnp.ndarray,
               damping: float = 1e-6):
    """``gn_step`` that also returns the applied twist update dx [6]."""
    Hd = H + damping * jnp.eye(6, dtype=H.dtype)
    dx = -jnp.linalg.solve(Hd, b)
    # guard: if the system is degenerate the solve may produce garbage
    dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros_like(dx))
    return se3.exp(dx) @ X, dx


def gn_iterate(
    system_fn: Callable[[jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray, GNStats]],
    X0: jnp.ndarray,
    iterations: int,
    damping: float = 1e-6,
    min_inliers: int = 6,
    epsilon: float = 0.0,
    unroll: bool = False,
):
    """Run up to ``iterations`` GN steps of a 6-DoF system inside one jit.

    A step only applies when at least ``min_inliers`` correspondences are
    active (guards degenerate solves); the final inlier count in the
    returned stats is the caller's success signal, mirroring the reference
    aligner's min_num_inliers status (kitti.conf:995) — inliers are NOT a
    per-step gate because early iterations legitimately start with large
    residuals.

    Termination: the burst stops applying updates as soon as the applied
    twist drops below ``epsilon`` — the reference solver's
    SimpleTerminationCriteria(epsilon) (kitti.conf:593-615).  The default
    ``epsilon=0.0`` stops only on an exactly-zero update — BIT-IDENTICAL
    to the fixed-count loop (remaining iterations would be no-ops),
    preserving the chunked==per-frame equivalence guarantee; a positive
    epsilon (TrackerConfig.gn_epsilon) trades that bit-stability for
    latency, since a 1e-7 cross-mode float difference can change the exit
    iteration.

    ``unroll`` chooses the execution scheme, NOT the semantics (the two
    are select-for-select equivalent, pinned by tests/test_gn.py):
      * False — a bounded ``lax.while_loop`` that exits early.  Best when
        iterations are long or vmapped (loop-closure validation).
      * True — a compile-time-unrolled chain with a sticky stop flag
        (post-termination iterations compute but never apply): no loop
        predicate is read between iterations, at the price of a larger
        program.
    """
    dummy = GNStats(jnp.float32(0), jnp.int32(0), jnp.int32(0))

    if unroll:
        X, stats = X0, dummy
        dx_norm = jnp.float32(jnp.inf)
        for _ in range(iterations):
            live = dx_norm > epsilon
            H, b, stats_i = system_fn(X)
            X_new, dx_step = gn_step_dx(X, H, b, damping)
            ok = stats_i.num_terms >= min_inliers
            X = jnp.where(live & ok, X_new, X)
            stats = jax.tree_util.tree_map(
                lambda a, b: jnp.where(live, a, b), stats_i, stats)
            dx_norm = jnp.where(
                live,
                jnp.where(ok, jnp.linalg.norm(dx_step), jnp.float32(0)),
                dx_norm)
        return X, stats

    def cond(carry):
        _, _, it, dx_norm = carry
        return (it < iterations) & (dx_norm > epsilon)

    def body(carry):
        X, _, it, _ = carry
        H, b, stats = system_fn(X)
        # the solve's dx IS the left-perturbation twist of this step
        # (X_new = exp(dx) X), so its norm is the update size directly —
        # recovering it as log(X_new X^-1) costs a log+inverse chain per
        # iteration (~= 5 solves, measured round 5) for the same value
        X_new, dx_step = gn_step_dx(X, H, b, damping)
        ok = stats.num_terms >= min_inliers
        X_next = jnp.where(ok, X_new, X)
        dx = jnp.where(ok, jnp.linalg.norm(dx_step), jnp.float32(0))
        return X_next, stats, it + 1, dx

    X, stats, _, _ = jax.lax.while_loop(
        cond, body, (X0, dummy, jnp.int32(0), jnp.float32(jnp.inf)))
    return X, stats
