"""Frame-to-map tracker: one fused jitted step of clip -> align -> merge.

Capability parity with the reference's MultiTracker3D + slice-processor flow
(reconstructed at reference srrg2_proslam/apps/app_benchmark.cpp:101-184 and
SURVEY.md §3.1): scene clipping (frustum culling,
mapping/scene_clipper_projective_3d.cpp:46-66), multi-round projective ICP
alignment (MultiAligner3DQR, §3.3), and the projective merger (landmark EKF
updates + binned insertion, mapping/mergers/merger_projective_impl.cpp:7-308)
— redesigned as ONE jit over fixed-capacity arrays:

  * the clipper's compacted cloud + globalIndices() bookkeeping becomes an
    in-view mask over the full arena, so matches index landmarks directly;
  * the aligner's per-iteration re-association becomes ``rounds`` static
    re-match/GN-burst cycles (the reference reprojects every 5 iterations,
    correspondence_finder_projective_base_impl.cpp:162-178 — same cadence);
  * the merger's serial per-correspondence loop becomes a vmapped EKF over
    all landmarks plus one ranked scatter insertion;
  * the host reads back a single small stats vector per frame to drive the
    status machine (SURVEY.md §7.3 hard part 6).

Works for both the stereo and RGB-D pipelines via the static ``model``
switch, mirroring the reference's stereo/depth slice variants.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import config as cfg
from ..ops import se3
from ..ops.pinhole import Camera, project, unproject
from ..ops.triangulation import triangulate_rectified
from ..ops.matching import Matches, ProjectiveMatcherConfig, match_projective
from ..ops.gn import (
    gn_iterate,
    projective_depth_system,
    stereo_projective_system,
)
from ..ops.ekf import LandmarkEKFConfig, ekf_update_batch, initial_covariance
from ..ops.landmark_estimators import (
    SmootherConfig,
    WeightedMeanConfig,
    add_measurements,
    empty_measurement_buffer,
    smoother_update_batch,
    weighted_mean_update_batch,
)
from . import landmarks as lm
from .landmarks import LandmarkArena


@cfg.register
class MergerConfig:
    """Mirrors MergerRigidStereoTriangulation params (kitti.conf:185-230)."""

    target_number_of_merges: int = 100
    maximum_distance_appearance: float = 100.0
    enable_binning: bool = True
    bin_size_px: int = 25
    max_additions: int = 512


@cfg.register
class TrackerConfig:
    matcher: ProjectiveMatcherConfig = ProjectiveMatcherConfig()
    merger: MergerConfig = MergerConfig()
    ekf: LandmarkEKFConfig = LandmarkEKFConfig()
    weighted_mean: WeightedMeanConfig = WeightedMeanConfig()
    smoother: SmootherConfig = SmootherConfig()
    # which landmark estimator refines matched landmarks at merge time,
    # mirroring the reference's config-selected estimator families
    # (LandmarkEstimatorEKF* | LandmarkEstimatorWeightedMean |
    # LandmarkEstimatorPoseBasedSmoother, kitti.conf):
    # "ekf" | "weighted_mean" | "smoother"
    landmark_estimator: str = "ekf"
    rounds: int = 3                   # re-association rounds
    gn_iterations: int = 5            # GN bursts per round (ref reprojects every 5)
    # SimpleTerminationCriteria(epsilon) analog (kitti.conf:593-615): a GN
    # burst exits early once the twist update drops below this.  0.0 keeps
    # the bit-exact fixed-count loop (cross-mode equivalence); production
    # configs may set ~1e-5 to cut the serial GN latency chain
    gn_epsilon: float = 0.0
    # unroll the GN bursts at compile time instead of a lax.while_loop —
    # select-for-select identical results (ops/gn.py::gn_iterate)
    gn_unroll: bool = False
    # run each stereo GN burst as ONE fused Pallas kernel
    # (ops/gn_pallas.py) instead of the XLA op chain.  Applies only on the
    # GPU, for the stereo factor, with the motion-prior factor off; the
    # sharded paths (GraphSLAM(mesh=...), parallel.slam_step_spmd) clear
    # it, since the kernel is a one-device program.  Equivalence pinned by
    # tests/test_gn_pallas.py
    gn_pallas: bool = True
    damping: float = 1e-6             # kitti.conf:831
    min_num_inliers: int = 6          # kitti.conf:994
    chi_threshold: float = 25.0       # RobustifierSaturated (kitti.conf:130-141)
    minimum_disparity_px: float = 1.0
    # sensor-in-robot extrinsic (row-major flattened 4x4), the analog of the
    # reference's TF platform + WithSensor factor variants
    # (aligner_slice_processor_projective.h:63-192, kitti_in_baselink.conf):
    # the tracker estimates the ROBOT pose while measurements live in the
    # sensor frame T_robot_sensor away.  Identity = camera==robot.
    T_robot_sensor: tuple = (1.0, 0.0, 0.0, 0.0,
                             0.0, 1.0, 0.0, 0.0,
                             0.0, 0.0, 1.0, 0.0,
                             0.0, 0.0, 0.0, 1.0)
    # constant-velocity prior factor inside the aligner (the reference's
    # AlignerSliceMotionModel3D on the trajectory_chunk slice,
    # kitti.conf:747-772): information (1/variance) of the prediction in
    # meters / radians.  0 disables the prior (prediction then only seeds
    # the initial guess).
    motion_prior_translation_info: float = 0.0
    motion_prior_rotation_info: float = 0.0
    # per-point inverse-depth weighting of the stereo slice: information
    # scaled by (0.01 + disparity/mean_disparity), nearer points (larger
    # disparity) constrain translation more
    # (aligner_slice_processor_projective.cpp:107-112, kitti.conf:271).
    # Off by default: with very few inliers the weighting amplifies
    # individual near points (measured on the bundled highway pair);
    # dataset configs opt in where it wins.
    stereo_inverse_depth_weighting: bool = False


class TrackerState(NamedTuple):
    arena: LandmarkArena
    T_lm_robot: jnp.ndarray     # robot pose in the local-map frame (4x4)
    velocity: jnp.ndarray       # constant-velocity twist [6] (robot frame/frame)
    # per-landmark camera-measurement ring buffers, present only when the
    # pose-based smoother estimator is selected (None otherwise — a static
    # property of the config, so jit sees a consistent pytree)
    meas_buf: object = None


class TrackStats(NamedTuple):
    """Per-frame outputs: scalar stats (the host status-machine readback)
    plus the final association (read only by consumers that need it, e.g.
    local bundle adjustment — JAX transfers leaves lazily)."""

    num_measurements: jnp.ndarray
    num_matches: jnp.ndarray
    num_inliers: jnp.ndarray
    chi_per_inlier: jnp.ndarray
    num_merges: jnp.ndarray
    num_additions: jnp.ndarray
    matcher_stage: jnp.ndarray
    # splitting-criterion scalars computed on device so the host status
    # machine needs ONE batched readback per frame (SURVEY §7.3 hard part 6)
    trans_in_map: jnp.ndarray  # |t| of the post-update robot-in-local-map
    rot_in_map: jnp.ndarray    # rotation angle of the same
    match_idx: jnp.ndarray    # [N] int32 landmark index per measurement (-1)
    match_mask: jnp.ndarray   # [N] bool
    # everything the host status machine consumes, packed into ONE [20] f32
    # vector so the orchestrator issues a single small async host copy per
    # frame instead of a blocking multi-leaf readback (VERDICT r2 item 1):
    # [num_inliers, trans_in_map, rot_in_map, num_matches, num_merges,
    #  num_additions, chi_per_inlier, matcher_stage, T_lm_robot[:3,:].ravel()]
    host_packet: jnp.ndarray


def initial_state(capacity: int, estimator: str = "ekf",
                  smoother_slots: int = 8) -> TrackerState:
    buf = (empty_measurement_buffer(capacity, smoother_slots)
           if estimator == "smoother" else None)
    return TrackerState(
        arena=lm.empty_arena(capacity),
        T_lm_robot=se3.identity(),
        velocity=jnp.zeros(6, jnp.float32),
        meas_buf=buf,
    )


def _adapt_to_sensor_points(points, valid, cam: Camera, model: str,
                            min_disparity: float):
    """Measurement rows -> 3-D sensor-frame points (+preference score)."""
    if model == "stereo":
        pts, ok = triangulate_rectified(cam, points, valid, min_disparity)
        # addition preference: higher disparity first (merger_projective_
        # rigid_stereo_impl.cpp:44-56)
        score = points[:, 0] - points[:, 2]
        return pts, ok, score
    pts, ok = unproject(cam, points)
    # depth variant prefers lower depth (merger_projective_depth_ekf_impl.cpp:44-53)
    return pts, ok & valid, -points[:, 2]


@partial(jax.jit, static_argnames=("config", "cam", "model"))
def track_step(
    state: TrackerState,
    meas_points: jnp.ndarray,   # [N, 4] stereo (uL vL uR vR) | [N, 3] rgbd (u v d)
    meas_desc: jnp.ndarray,     # [N, 256] int8
    meas_valid: jnp.ndarray,    # [N] bool
    cam: Camera,
    config: TrackerConfig,
    model: str = "stereo",
):
    """One full tracker step. Returns (new_state, stats, X_final).

    ``X_final`` maps local-map points into the sensor frame (the aligner's
    movingInFixed estimate).
    """
    arena = state.arena
    # sensor-in-robot extrinsic (WithSensor factor analog): the GN estimate
    # X maps local-map points into the SENSOR frame; the robot pose is
    # recovered through T_robot_sensor at the end
    T_rs = jnp.asarray(config.T_robot_sensor, jnp.float32).reshape(4, 4)
    T_sr = se3.inverse(T_rs)
    # ---- motion-model prediction (MotionModelConstantVelocity3D analog,
    # kitti.conf:747-772) ----------------------------------------------------
    T_pred = state.T_lm_robot @ se3.exp(state.velocity)
    X_pred = se3.inverse(T_pred @ T_rs)   # sensor-from-localmap prediction
    X = X_pred

    meas_uv = meas_points[:, :2]
    if model == "stereo":
        gn_meas = meas_points[:, :3]  # (uL, vL, uR)
    else:
        gn_meas = meas_points          # (u, v, d)

    weights_all = 1.0 + jnp.log1p(arena.num_updates.astype(jnp.float32))

    # constant-velocity prior factor (AlignerSliceMotionModel3D analog):
    # quadratic pull of the estimate toward the prediction, linearized with
    # unit Jacobian in the left-perturbation parametrization
    prior_w = jnp.concatenate([
        jnp.full((3,), config.motion_prior_translation_info, jnp.float32),
        jnp.full((3,), config.motion_prior_rotation_info, jnp.float32),
    ])
    use_prior = (config.motion_prior_translation_info > 0.0
                 or config.motion_prior_rotation_info > 0.0)

    def with_motion_prior(system):
        if not use_prior:
            return system

        def wrapped(Xc):
            H, b, stats = system(Xc)
            r = se3.log(Xc @ se3.inverse(X_pred))
            return H + jnp.diag(prior_w), b + prior_w * r, stats

        return wrapped

    # ---- alignment: static re-association rounds ---------------------------
    # coarse-to-fine radius schedule over rounds: loosest stage while the
    # motion prediction is cold, tightest at the end — the fixed-shape
    # equivalent of the reference matcher's widen/shrink radius dynamics
    # (correspondence_finder_projective_base_impl.cpp:227-288)
    # per-point inverse-depth (disparity) information weighting of the
    # stereo slice (aligner_slice_processor_projective.cpp:107-112)
    if model == "stereo" and config.stereo_inverse_depth_weighting:
        disp = meas_points[:, 0] - meas_points[:, 2]
        mean_disp = jnp.sum(jnp.where(meas_valid, disp, 0.0)) / jnp.maximum(
            jnp.sum(meas_valid), 1
        )
        idw = 0.01 + disp / jnp.maximum(mean_disp, 1e-3)
    else:
        idw = jnp.ones((meas_points.shape[0],), jnp.float32)

    n_stages = len(config.matcher.radius_stages)
    matches = None
    stage = jnp.int32(0)
    stats = None
    for r in range(config.rounds):
        # scene clipping = frustum mask over the whole arena (M2 redesign)
        pts_sensor = se3.transform_points(X, arena.pos)
        proj_uv, in_view = project(cam, pts_sensor)
        proj_valid = arena.valid & in_view
        # rounds 0..n-2 force the loose-to-tight schedule; the FINAL round
        # uses the adaptive tightest-good-stage selection so the matcher can
        # still widen when the converged prediction is bad (the reference's
        # widen-on-loss fallback) and ``stage`` stays a live health signal
        is_final = r == config.rounds - 1
        matches, stage = match_projective(
            meas_uv, meas_desc, meas_valid,
            proj_uv, arena.desc, proj_valid,
            config.matcher,
            force_stage=-1 if is_final else max(n_stages - 1 - r, 0),
        )
        idx = jnp.maximum(matches.idx, 0)
        pts_moving = arena.pos[idx]
        weights = weights_all[idx] * idw

        if model == "stereo":
            system = lambda Xc, pm=pts_moving, w=weights, mk=matches.mask: (
                stereo_projective_system(
                    Xc, pm, gn_meas, w, mk, cam, config.chi_threshold)
            )
        else:
            system = lambda Xc, pm=pts_moving, w=weights, mk=matches.mask: (
                projective_depth_system(
                    Xc, pm, gn_meas, w, mk, cam, config.chi_threshold)
            )
        use_pallas_gn = (
            config.gn_pallas and model == "stereo" and not use_prior
            and jax.default_backend() == "gpu"
        )
        if use_pallas_gn:
            from ..ops.gn_pallas import gn_burst_stereo

            X, stats = gn_burst_stereo(
                X, pts_moving, gn_meas, weights, matches.mask, cam,
                iterations=config.gn_iterations, damping=config.damping,
                min_inliers=config.min_num_inliers,
                epsilon=config.gn_epsilon,
                chi_threshold=config.chi_threshold,
            )
        else:
            X, stats = gn_iterate(
                with_motion_prior(system), X, config.gn_iterations,
                damping=config.damping, min_inliers=config.min_num_inliers,
                epsilon=config.gn_epsilon, unroll=config.gn_unroll,
            )

    # ---- merge: EKF update of matched landmarks ----------------------------
    M = arena.capacity
    # scatter measurement rows to their matched landmark slot
    idx_safe = jnp.where(matches.mask, matches.idx, M)
    meas_dim = meas_points.shape[1]
    z_by_lm = jnp.zeros((M + 1, meas_dim), jnp.float32).at[idx_safe].set(meas_points)[:M]
    desc_by_lm = jnp.zeros((M + 1, arena.desc.shape[1]), jnp.int8).at[idx_safe].set(meas_desc)[:M]
    matched_lm = jnp.zeros((M + 1,), bool).at[idx_safe].set(matches.mask)[:M]
    # appearance gate (merger_projective_impl.cpp:72-75)
    dist_by_lm = jnp.full((M + 1,), 1e9, jnp.float32).at[idx_safe].set(matches.distance)[:M]
    matched_lm = matched_lm & (dist_by_lm <= config.merger.maximum_distance_appearance)

    meas_buf = state.meas_buf
    if config.landmark_estimator == "smoother":
        # reference LandmarkEstimatorPoseBasedSmoother: buffer this frame's
        # observation per landmark, then structure-only GN over ALL buffered
        # observations of every landmark (vmapped)
        p_sensor_meas, meas_ok, _ = _adapt_to_sensor_points(
            z_by_lm, matched_lm, cam, model, config.minimum_disparity_px
        )
        meas_buf = add_measurements(
            meas_buf, z_by_lm[:, :2], p_sensor_meas, X,
            matched_lm & meas_ok,
        )
        sm = smoother_update_batch(
            arena.pos, meas_buf, arena.num_updates,
            arena.valid & matched_lm, cam, config.smoother,
        )
        new_pos, new_cov, accepted = sm.position, arena.cov, sm.accepted
    elif config.landmark_estimator == "weighted_mean":
        # reference LandmarkEstimatorWeightedMean: running count-weighted
        # mean of sensor_in_world * landmark_in_sensor
        p_sensor_meas, meas_ok, _ = _adapt_to_sensor_points(
            z_by_lm, matched_lm, cam, model, config.minimum_disparity_px
        )
        p_world_meas = se3.transform_points(se3.inverse(X), p_sensor_meas)
        wm = weighted_mean_update_batch(
            arena.pos, arena.num_updates, p_world_meas,
            matched_lm & meas_ok, config.weighted_mean,
        )
        new_pos, new_cov, accepted = wm.position, arena.cov, wm.accepted
    else:
        ekf_model = "stereo" if model == "stereo" else "projective_depth"
        ekf_out = ekf_update_batch(
            arena.pos, arena.cov, z_by_lm, matched_lm, X, cam, ekf_model,
            config.ekf,
        )
        new_pos, new_cov, accepted = (
            ekf_out.position, ekf_out.covariance, ekf_out.accepted
        )
    num_merges = jnp.sum(accepted)
    arena = arena._replace(
        pos=new_pos,
        cov=new_cov,
        desc=jnp.where(matched_lm[:, None], desc_by_lm, arena.desc),
        num_updates=arena.num_updates + accepted.astype(jnp.int32),
    )

    # ---- merge: ranked binned insertion of unmatched measurements ----------
    pts_sensor_new, tri_ok, pref = _adapt_to_sensor_points(
        meas_points, meas_valid, cam, model, config.minimum_disparity_px
    )
    unmatched = meas_valid & ~matches.mask & tri_ok
    allow_adds = num_merges < config.merger.target_number_of_merges

    # ONE preference sort serves both the bin ranking and the insertion
    # order: lm.insert compacts by ``want`` preserving relative order, so
    # ranking pre-binning candidates and masking the bin losers afterward
    # yields bit-identical insertions to re-sorting the filtered set
    # (which cost two extra argsorts per frame, measured round 5)
    N_meas = meas_points.shape[0]
    order = jnp.argsort(jnp.where(unmatched, -pref, jnp.inf)).astype(jnp.int32)
    if config.merger.enable_binning:
        # bin occupancy from current landmark projections (merger_projective_
        # impl.cpp:90-124 redesigned as a scatter-occupancy grid)
        bs = config.merger.bin_size_px
        n_bu = -(-cam.cols // bs)
        n_bv = -(-cam.rows // bs)
        n_bins = n_bu * n_bv

        def bin_id(uv):
            bu = jnp.clip(uv[:, 0].astype(jnp.int32) // bs, 0, n_bu - 1)
            bv = jnp.clip(uv[:, 1].astype(jnp.int32) // bs, 0, n_bv - 1)
            return bv * n_bu + bu

        pts_sensor_map = se3.transform_points(X, arena.pos)
        map_uv, map_in_view = project(cam, pts_sensor_map)
        map_bins = jnp.where(arena.valid & map_in_view, bin_id(map_uv), n_bins)
        occupied = jnp.zeros((n_bins + 1,), bool).at[map_bins].set(True)[:n_bins]
        cand_bins = bin_id(meas_uv)
        # best (highest preference) candidate per bin wins; the dense rank
        # is the inverse permutation of ``order`` (scattered iota — cheaper
        # than the former argsort-of-argsort)
        rank = jnp.zeros((N_meas,), jnp.int32).at[order].set(
            jnp.arange(N_meas, dtype=jnp.int32))
        best_rank = jnp.full((n_bins + 1,), 1 << 30, jnp.int32).at[
            jnp.where(unmatched, cand_bins, n_bins)
        ].min(jnp.where(unmatched, rank, 1 << 30))[:n_bins]
        first_in_bin = rank == best_rank[jnp.clip(cand_bins, 0, n_bins - 1)]
        unmatched = unmatched & first_in_bin & ~occupied[jnp.clip(cand_bins, 0, n_bins - 1)]

    T_sensor_to_lm = se3.inverse(X)
    pts_lm = se3.transform_points(T_sensor_to_lm, pts_sensor_new)
    cov0 = initial_covariance(pts_sensor_new[:, 2], cam)
    R = T_sensor_to_lm[:3, :3]
    cov0_lm = jnp.einsum("ij,mjk,lk->mil", R, cov0, R)
    want = unmatched[order] & allow_adds
    free_slots = arena.capacity - jnp.sum(arena.valid)
    arena = lm.insert(
        arena,
        pts_lm[order],
        cov0_lm[order],
        meas_desc[order],
        want,
        config.merger.max_additions,
    )
    # report what lm.insert actually applied (capped by the insertion
    # budget and the free arena slots), not the raw candidate count
    num_additions = jnp.minimum(
        jnp.sum(want),
        jnp.minimum(config.merger.max_additions, free_slots),
    )

    # ---- pose & velocity update --------------------------------------------
    # robot pose recovered through the sensor extrinsic:
    # T_lm_robot = T_lm_sensor @ T_sensor_robot
    T_lm_robot_new = se3.inverse(X) @ T_sr
    # velocity only refreshes when alignment had enough support; otherwise
    # keep the previous model (reference resets motion on track loss at the
    # matcher level, correspondence_finder_projective_base_impl.cpp:251-258)
    aligned = stats.num_inliers >= config.min_num_inliers
    vel_new = se3.log(se3.inverse(state.T_lm_robot) @ T_lm_robot_new)
    new_state = TrackerState(
        arena=arena,
        T_lm_robot=jnp.where(aligned, T_lm_robot_new, T_pred),
        velocity=jnp.where(aligned, vel_new, state.velocity),
        meas_buf=meas_buf,
    )
    T_final = new_state.T_lm_robot
    num_inliers = stats.num_inliers
    chi_per_inlier = stats.chi_total / jnp.maximum(stats.num_inliers, 1)
    trans_in_map = jnp.linalg.norm(T_final[:3, 3])
    rot_in_map = jnp.linalg.norm(se3.log_so3(T_final[:3, :3]))
    host_packet = jnp.concatenate([
        jnp.stack([
            num_inliers.astype(jnp.float32),
            trans_in_map,
            rot_in_map,
            matches.count.astype(jnp.float32),
            num_merges.astype(jnp.float32),
            num_additions.astype(jnp.float32),
            chi_per_inlier,
            stage.astype(jnp.float32),
        ]),
        T_final[:3, :].reshape(12),
    ])
    out_stats = TrackStats(
        num_measurements=jnp.sum(meas_valid),
        num_matches=matches.count,
        num_inliers=num_inliers,
        chi_per_inlier=chi_per_inlier,
        num_merges=num_merges,
        num_additions=num_additions,
        matcher_stage=stage,
        trans_in_map=trans_in_map,
        rot_in_map=rot_in_map,
        match_idx=matches.idx,
        match_mask=matches.mask,
        host_packet=host_packet,
    )
    return new_state, out_stats, jnp.where(aligned, X, X_pred)
