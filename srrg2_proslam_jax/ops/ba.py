"""Local bundle adjustment: batched Schur-complement Gauss-Newton.

The reference performs structure-only refinement (landmark estimators) and
pose-only alignment plus pose-graph optimization; full joint structure+pose
bundle adjustment is the capability its srrg2_solver dependency provides via
SE3 projective factor graphs (reference srrg2_proslam configurations/
kitti.conf:593-615 wires that solver; SURVEY.md §7.2 step 8 names BA as the
capability to replicate).  This module is the accelerator-native design:

  * fixed-capacity observation arrays (obs -> keyframe, obs -> landmark,
    stereo/depth measurement rows, validity mask) — no factor objects;
  * one GN iteration = batched residual/Jacobian evaluation over ALL
    observations, block reduction into Hpp [P,6,6] / Hll [L,3,3] /
    per-(landmark, keyframe) coupling blocks, Schur elimination of the
    landmark blocks (Hll is block-diagonal, inverted in closed form), a
    dense reduced [6P, 6P] camera-system solve, and landmark
    back-substitution — all inside one jit;
  * the observation-level reductions are segment-sums, so sharding the
    observation axis across a device mesh turns them into psums (the
    distributed-BA layout of SURVEY.md §2.3: landmark-block partitioning
    with collective reduction of the camera system).

Robustification uses the saturated kernel (matching the aligner's
RobustifierSaturated policy); gauge freedom is fixed by an anchor prior on
keyframe 0.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import config as cfg
from . import se3
from .pinhole import Camera


@cfg.register
class BAConfig:
    iterations: int = 5
    damping: float = 1e-3            # Levenberg diagonal damping
    chi_threshold: float = 25.0      # saturated robust kernel
    anchor_weight: float = 1e6       # gauge prior on keyframe 0
    depth_weight: float = 1.0        # extra weight on the third residual row
    # refine landmarks with the keyframe poses FROZEN (skips the Schur
    # camera solve entirely).  Root-cause of the round-3/4 local-BA
    # accuracy regression (ATE 0.428 -> 0.502, scripts/ab_local_ba.py):
    # joint BA moves the keyframe poses, but only the refined POINTS were
    # consumed — the map's internal gauge shifted relative to the
    # odometry chain (T_split, the odometry factor, and the per-frame
    # records all keep the unrefined poses), biasing closure validation
    # against the database.  Structure-only refinement keeps the map
    # frame consistent with the chain by construction (it is the
    # multi-view generalization of the reference's pose-based smoother,
    # landmark_estimator_pose_based_smoother_impl.cpp:55-133).
    structure_only: bool = True


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem.

    poses: [P, 4, 4] world_from_keyframe estimates;
    points: [L, 3] world-frame landmarks;
    obs_kf/obs_lm: [O] indices; obs_z: [O, 3] measurements
    ((uL, vL, uR) stereo or (u, v, depth) RGB-D); obs_valid: [O] mask.
    """

    poses: jnp.ndarray
    pose_valid: jnp.ndarray
    points: jnp.ndarray
    point_valid: jnp.ndarray
    obs_kf: jnp.ndarray
    obs_lm: jnp.ndarray
    obs_z: jnp.ndarray
    obs_valid: jnp.ndarray


def empty_problem(num_poses: int, num_points: int, num_obs: int) -> BAProblem:
    return BAProblem(
        poses=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (num_poses, 4, 4)),
        pose_valid=jnp.zeros((num_poses,), bool),
        points=jnp.zeros((num_points, 3), jnp.float32),
        point_valid=jnp.zeros((num_points,), bool),
        obs_kf=jnp.zeros((num_obs,), jnp.int32),
        obs_lm=jnp.zeros((num_obs,), jnp.int32),
        obs_z=jnp.zeros((num_obs, 3), jnp.float32),
        obs_valid=jnp.zeros((num_obs,), bool),
    )


def _observation_terms(poses, points, problem: BAProblem, cam: Camera,
                       model: str, chi_threshold: float, depth_weight: float):
    """Residuals + pose/point Jacobians for every observation.

    The estimate maps world -> camera: T_cw = poses[kf]^-1 (poses store
    world_from_keyframe).  Pose perturbation is left-multiplied on the
    world_from_keyframe estimate: T_wk <- T_wk exp(-dx) would tangle frames,
    so we perturb the inverse: T_cw <- exp(dx) T_cw, giving the same
    [I | -skew(p_cam)] chain rule as the aligner (ops/gn.py).
    """
    T_cw = se3.inverse(poses)[problem.obs_kf]          # [O, 4, 4]
    p_w = points[problem.obs_lm]                        # [O, 3]
    R = T_cw[:, :3, :3]
    p_c = jnp.einsum("oij,oj->oi", R, p_w) + T_cw[:, :3, 3]
    x, y, z = p_c[:, 0], p_c[:, 1], p_c[:, 2]
    z_safe = jnp.maximum(z, 1e-3)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    sw = jnp.sqrt(depth_weight)
    if model == "stereo":
        third = u - cam.baseline_px * iz
        row3 = jnp.stack([cam.fx * iz, zero,
                          (-cam.fx * x + cam.baseline_px) * iz2], -1)
    else:
        third = z
        row3 = jnp.stack([zero, zero, one], -1)
    r = jnp.stack([u, v, sw * third], -1) \
        - problem.obs_z * jnp.array([1.0, 1.0, sw])
    Jh = jnp.stack(
        [
            jnp.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
            jnp.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
            sw * row3,
        ],
        axis=-2,
    )  # [O, 3, 3] d(residual)/d(p_cam)
    # pose block: d(p_cam)/d(dx) = [I | -skew(p_cam)]
    Jx = jnp.concatenate(
        [jnp.broadcast_to(jnp.eye(3), Jh.shape), -se3.skew(p_c)], axis=-1
    )
    Jp = Jh @ Jx            # [O, 3, 6]
    Jl = Jh @ R             # [O, 3, 3] d(p_cam)/d(p_world) = R
    mask = problem.obs_valid & (z > cam.range_min)
    chi = jnp.sum(r * r, axis=-1)
    kw = jnp.minimum(1.0, chi_threshold / jnp.maximum(chi, 1e-9))
    w = jnp.where(mask, kw, 0.0)
    chi_total = jnp.sum(jnp.where(mask, jnp.minimum(chi, chi_threshold), 0.0))
    return r, Jp, Jl, w, chi_total


def _gn_iteration(poses, points, problem: BAProblem, cam: Camera, model: str,
                  config: BAConfig):
    P = poses.shape[0]
    L = points.shape[0]
    r, Jp, Jl, w, chi_total = _observation_terms(
        poses, points, problem, cam, model,
        config.chi_threshold, config.depth_weight,
    )
    kf = problem.obs_kf
    lm = problem.obs_lm

    # block accumulations (segment-sum over observations -> psum-ready)
    Hll = jnp.zeros((L, 3, 3)).at[lm].add(jnp.einsum("odi,odj,o->oij", Jl, Jl, w))
    bl = jnp.zeros((L, 3)).at[lm].add(jnp.einsum("odi,od,o->oi", Jl, r, w))

    if config.structure_only:
        # poses frozen: per-landmark damped 3x3 solves, no camera system
        Hll_d = Hll + (config.damping + 1e-6) * jnp.eye(3)
        dx_l = -jnp.einsum("lij,lj->li", jnp.linalg.inv(Hll_d), bl)
        dx_l = jnp.where(jnp.isfinite(dx_l), dx_l, 0.0)
        observed = jnp.zeros((L,), bool).at[lm].max(w > 0)
        new_points = jnp.where(
            (problem.point_valid & observed)[:, None], points + dx_l, points
        )
        return poses, new_points, chi_total

    Hpp = jnp.zeros((P, 6, 6)).at[kf].add(jnp.einsum("odi,odj,o->oij", Jp, Jp, w))
    bp = jnp.zeros((P, 6)).at[kf].add(jnp.einsum("odi,od,o->oi", Jp, r, w))
    # per-(landmark, keyframe) coupling W[l, p] = sum_o Jp^T Jl
    W = jnp.zeros((L, P, 6, 3)).at[lm, kf].add(
        jnp.einsum("odi,odj,o->oij", Jp, Jl, w)
    )

    # damp + invert the landmark blocks in closed form (block-diagonal)
    Hll_d = Hll + (config.damping + 1e-6) * jnp.eye(3)
    Hll_inv = jnp.linalg.inv(Hll_d)

    # Schur complement of the camera system:
    # S = Hpp - sum_l W_l Hll_l^-1 W_l^T   (cross-keyframe fill-in included)
    Y = jnp.einsum("lpij,ljk->lpik", W, Hll_inv)          # [L, P, 6, 3]
    S_red = jnp.einsum("lpik,lqjk->piqj", Y, W)           # [P, 6, P, 6]
    b_red = bp - jnp.einsum("lpik,lk->pi", Y, bl)

    S = jnp.zeros((P, 6, P, 6)).at[...].set(-S_red)
    idx = jnp.arange(P)
    S = S.at[idx, :, idx, :].add(Hpp)
    # gauge anchor + damping + SPD floor for empty keyframes
    prior = jnp.where(jnp.arange(P) == 0, config.anchor_weight,
                      jnp.where(problem.pose_valid, config.damping, 1.0))
    S = S.at[idx, :, idx, :].add(prior[:, None, None] * jnp.eye(6))

    dx_p = -jnp.linalg.solve(S.reshape(6 * P, 6 * P), b_red.reshape(-1))
    dx_p = jnp.where(jnp.all(jnp.isfinite(dx_p)), dx_p, jnp.zeros_like(dx_p))
    dx_p = dx_p.reshape(P, 6)

    # landmark back-substitution: dx_l = -Hll^-1 (bl + W^T dx_p)
    rhs = bl + jnp.einsum("lpij,pi->lj", W, dx_p)
    dx_l = -jnp.einsum("lij,lj->li", Hll_inv, rhs)
    dx_l = jnp.where(jnp.isfinite(dx_l), dx_l, 0.0)
    observed = jnp.zeros((L,), bool).at[lm].max(w > 0)

    # apply updates: pose perturbation was defined on T_cw = T_wk^-1,
    # so T_wk <- (exp(dx) T_wk^-1)^-1 = T_wk exp(-dx)
    new_poses = jax.vmap(lambda T, d: T @ se3.exp(-d))(poses, dx_p)
    new_points = jnp.where(
        (problem.point_valid & observed)[:, None], points + dx_l, points
    )
    return new_poses, new_points, chi_total


@partial(jax.jit, static_argnames=("cam", "model", "config"))
def optimize(problem: BAProblem, cam: Camera, model: str = "stereo",
             config: BAConfig = BAConfig()):
    """Joint pose+structure GN; returns (problem', chi_final)."""

    def body(_, carry):
        poses, points, _ = carry
        poses, points, chi = _gn_iteration(
            poses, points, problem, cam, model, config
        )
        return poses, points, chi

    poses, points, chi = jax.lax.fori_loop(
        0, config.iterations, body,
        (problem.poses, problem.points, jnp.float32(0)),
    )
    return problem._replace(poses=poses, points=points), chi
