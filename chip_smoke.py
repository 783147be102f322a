#!/usr/bin/env python3
"""Run the SLAM pipeline once on the GPU through its normal entry points.

Phases, in one process that opens the card once:
  1. device: JAX's device and the card's name and power limit;
  2. kernels: every hand-written kernel, compiled, against its plain-JAX
     reference at the pipeline's widths;
  3. chunked SLAM: the bench.py headline (253-frame rendered closed loop,
     480x640 stereo, chunk size 16) through ``GraphSLAM.process_sequence``,
     checked against the rendered ground truth under the reference gates;
  4. per-frame SLAM: the same frames through ``adapt_stereo`` +
     ``GraphSLAM.process``, compared with phase 3;
  5. KITTI width: the 5-frame VO gate of scripts/smoke_vo.py;
  6. RGB-D: ``adapt_rgbd`` + ``GraphSLAM(model="rgbd")`` on the bundled ICL
     frames.

``--four-cards`` runs phase 3 on a 1-D mesh over four cards, then on one
card, compares the two, and runs no other phase.

Each phase prints one line with its wall time, compile time and result.
The last line of stdout is one JSON object naming the device, printed only
when every phase passed.  Without a GPU the script exits non-zero before
any phase.  ``--cpu-rehearsal`` drives the same code at tiny shapes on the
CPU, checks no gate and prints no result line.

Run: python chip_smoke.py [--four-cards]
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# reference gates: scripts/rendered_e2e.py (rendered loop), smoke_vo.py
# (KITTI, reference tests/test_trackers.cpp:327-365), smoke_rgbd.py (ICL)
LOOP_T_RMSE_M = 0.30
LOOP_ROT_DEG = 3.0
KITTI_T_ERR_M = (0.2, 0.2, 0.7)
KITTI_ROT_RAD = 0.01
RGBD_T_ERR_M = 5e-3
RGBD_ROT_RAD = 0.01
# chunked vs per-frame (and mesh vs one card): the runs share the tracker
# math but not XLA's fusion and reduction order, and gn_epsilon > 0 lets
# a last-bit difference change a GN burst's exit iteration — a third of
# the loop gate bounds the largest per-frame position difference
TRAJ_DIFF_TOL_M = 0.10
# compiled kernel vs plain-JAX reference, both f32: the reductions run in
# another order and the 6x6 solve is Cholesky instead of pivoted LU
GN_POSE_TOL = 1e-3
GN_INLIER_TOL = 1


class Phases:
    """Runs phases, timing wall and XLA compile time; remembers failures."""

    def __init__(self):
        import jax

        self.compile_s = 0.0
        self.failed = []

        def on_event(event, duration, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.compile_s += duration

        jax.monitoring.register_event_duration_secs_listener(on_event)

    def run(self, name, fn, *args):
        self.compile_s = 0.0
        t0 = time.perf_counter()
        try:
            ok, result = fn(*args)
        except Exception:  # report the phase as failed, run the others
            traceback.print_exc()
            ok, result = False, "raised (traceback on stderr)"
        wall = time.perf_counter() - t0
        print(f"[{name}] wall={wall:.1f}s compile={self.compile_s:.1f}s "
              f"{'PASS' if ok else 'FAIL'}: {result}", flush=True)
        if not ok:
            self.failed.append(name)


def _sizes(rehearsal):
    """Shapes of the run: the bench headline, or tiny for the CPU."""
    if rehearsal:
        return dict(frames=24, rows=120, cols=160, fx=112.5, chunk=8)
    return dict(frames=253, rows=480, cols=640, fx=450.0, chunk=16)


def _slam_config(rehearsal, **kw):
    import bench
    from srrg2_proslam_jax.utils import config as cfg

    config = bench._slam_config(**kw)
    if rehearsal:
        config = cfg.replace(config, arena_capacity=512,
                             database_capacity=2048,
                             max_db_descriptors_per_map=64,
                             max_local_maps=16, max_edges=64)
    return config


def _adaptor_config(rehearsal):
    from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig
    from srrg2_proslam_jax.utils import config as cfg

    acfg = StereoAdaptorConfig()
    if rehearsal:
        acfg = cfg.replace(acfg, extractor=cfg.replace(acfg.extractor,
                                                       max_keypoints=144))
    return acfg


def phase_device(smi):
    import jax

    devs = jax.devices()
    return True, (f"{devs} kind={devs[0].device_kind!r} "
                  f"nvidia-smi: {smi}")


def phase_kernels(rehearsal):
    """The fused GN burst against gn_iterate at the tracker's widths."""
    import jax.numpy as jnp
    from srrg2_proslam_jax.io.datasets import kitti_camera
    from srrg2_proslam_jax.io.synthetic import synthetic_camera
    from srrg2_proslam_jax.models.tracker import TrackerConfig
    from srrg2_proslam_jax.ops import gn, se3
    from srrg2_proslam_jax.ops.features import FeatureExtractorConfig
    from srrg2_proslam_jax.ops.gn_pallas import gn_burst_stereo

    C = FeatureExtractorConfig().max_keypoints          # 1152
    iters = TrackerConfig().gn_iterations               # 5
    rng = np.random.RandomState(0)
    lines, ok = [], True
    for cam in (synthetic_camera(), kitti_camera()):
        pts = np.stack([rng.uniform(-8, 8, C), rng.uniform(-3, 3, C),
                        rng.uniform(4, 40, C)], 1).astype(np.float32)
        X_gt = se3.exp(jnp.asarray([0.05, -0.02, 0.3, 0.01, -0.02, 0.005]))
        p = np.asarray(se3.transform_points(X_gt, jnp.asarray(pts)))
        u = cam.fx * p[:, 0] / p[:, 2] + cam.cx
        meas = np.stack([u, cam.fy * p[:, 1] / p[:, 2] + cam.cy,
                         u - cam.baseline_px / p[:, 2]], 1)
        meas += rng.normal(0, 0.5, meas.shape)
        meas[:100] += rng.uniform(20, 80, (100, 3))        # outliers
        args = (jnp.asarray(pts), jnp.asarray(meas, jnp.float32),
                jnp.asarray(rng.uniform(0.5, 2, C), jnp.float32),
                jnp.arange(C) < C - 152)
        for eps in (0.0, 1e-5):
            system = lambda X: gn.stereo_projective_system(
                X, *args, cam, 25.0)
            X_ref, s_ref = gn.gn_iterate(system, se3.identity(), iters,
                                         epsilon=eps)
            X_k, s_k = gn_burst_stereo(se3.identity(), *args, cam=cam,
                                       iterations=iters, epsilon=eps,
                                       interpret=rehearsal)
            diff = float(np.max(np.abs(np.asarray(X_k) - np.asarray(X_ref))))
            d_inl = abs(int(s_k.num_inliers) - int(s_ref.num_inliers))
            good = (diff <= GN_POSE_TOL and d_inl <= GN_INLIER_TOL
                    and int(s_k.num_terms) == int(s_ref.num_terms))
            ok &= good
            lines.append(f"{cam.cols}x{cam.rows} eps={eps:g}: max|dX|="
                         f"{diff:.2e} inliers {int(s_k.num_inliers)}/"
                         f"{int(s_ref.num_inliers)}")
    return ok, (f"gn_burst_stereo (Triton) vs gn_iterate, C={C}, "
                f"{iters} iterations, f32, tol |dX|<={GN_POSE_TOL:g} "
                f"inliers+-{GN_INLIER_TOL}: " + "; ".join(lines))


def render_loop(rehearsal):
    """The rendered closed loop (bench.py's scene), images on device."""
    import jax
    import jax.numpy as jnp
    from srrg2_proslam_jax.io import synthetic as syn

    sz = _sizes(rehearsal)
    cam = syn.synthetic_camera(sz["rows"], sz["cols"], fx=sz["fx"])
    planes = syn.make_room(size_x=22.0, size_z=32.0)
    T_cw = syn.loop_trajectory()[:sz["frames"]]
    pairs = [syn.render_stereo(cam, jnp.asarray(T), planes)[:2]
             for T in T_cw]
    lefts = jnp.stack([p[0] for p in pairs])
    rights = jnp.stack([p[1] for p in pairs])
    jax.block_until_ready(rights)
    gt = [np.linalg.inv(T).astype(np.float32) for T in T_cw]
    return cam, lefts, rights, gt


def _gates(slam, gt, rehearsal):
    from srrg2_proslam_jax.metrics import trajectory as tm

    traj = slam.trajectory()
    err = tm.evaluate(traj, gt)
    ok = (bool(np.all(err.mean_translation_rmse <= LOOP_T_RMSE_M))
          and err.mean_rotation_deg <= LOOP_ROT_DEG
          and slam.num_closures >= 1
          and all(np.all(np.isfinite(T)) for T in traj))
    text = (f"maps={slam.num_maps} closures={slam.num_closures} "
            f"relocalizations={slam.num_relocalizations} "
            f"t_rmse={np.round(err.mean_translation_rmse, 3).tolist()} m "
            f"(gate {LOOP_T_RMSE_M}) rot={err.mean_rotation_deg:.2f} deg "
            f"(gate {LOOP_ROT_DEG}) closures>=1")
    return (ok or rehearsal), text, traj


def _chunk_memory(slam, lefts, rights, acfg):
    """memory_analysis() of the compiled chunk op at the run's shapes."""
    import jax.numpy as jnp
    from srrg2_proslam_jax.models import chunk as chunk_ops

    c = slam.config
    B = c.chunk_size
    pad = -lefts.shape[0] % B
    a = jnp.concatenate([lefts, jnp.zeros((pad,) + lefts.shape[1:])])
    b = jnp.concatenate([rights, jnp.zeros((pad,) + rights.shape[1:])])
    t0 = time.perf_counter()
    compiled = chunk_ops.fused_image_chunk_op.lower(
        slam._carry, a, b, 0, 0, B, slam.cam, acfg, c.tracker, slam.model,
        B, c.min_track_inliers, c.splitting.maximum_translation_m,
        c.splitting.maximum_rotation_rad, c.loop, c.pgo,
        c.max_db_descriptors_per_map, c.enable_loop_closing,
        group_size=1).compile()
    m = compiled.memory_analysis()
    return (f"chunk op (lower+compile {time.perf_counter() - t0:.1f}s, "
            f"cache warm): args={m.argument_size_in_bytes / 1e6:.1f} MB "
            f"out={m.output_size_in_bytes / 1e6:.1f} MB "
            f"temp={m.temp_size_in_bytes / 1e6:.1f} MB "
            f"code={m.generated_code_size_in_bytes / 1e6:.1f} MB")


def run_chunked(loop, rehearsal, mesh=None):
    from srrg2_proslam_jax.models.slam import GraphSLAM

    cam, lefts, rights, gt = loop
    acfg = _adaptor_config(rehearsal)
    config = _slam_config(rehearsal, chunk_size=_sizes(rehearsal)["chunk"])
    slam = GraphSLAM(cam, config, model="stereo", mesh=mesh)
    slam.process_sequence(lefts, rights,
                          [0.1 * i for i in range(len(gt))], acfg)
    return slam


def phase_chunked(loop, rehearsal, out):
    import jax

    cam, lefts, rights, gt = loop
    slam = run_chunked(loop, rehearsal)
    ok, text, traj = _gates(slam, gt, rehearsal)
    out["chunked"] = (slam.num_maps, slam.num_closures, traj)
    mem = _chunk_memory(slam, lefts, rights, _adaptor_config(rehearsal))
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    peak = "not reported" if peak is None else f"{peak / 1e9:.2f} GB"
    return ok, f"{text}; {mem}; device peak {peak}"


def _traj_diff(a, b):
    return max(float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]))
               for Ta, Tb in zip(a, b))


def phase_per_frame(loop, rehearsal, out):
    from srrg2_proslam_jax.models.frontend import adapt_stereo
    from srrg2_proslam_jax.models.slam import GraphSLAM

    cam, lefts, rights, gt = loop
    acfg = _adaptor_config(rehearsal)
    slam = GraphSLAM(cam, _slam_config(rehearsal, speculation_depth=0),
                     model="stereo")
    for i in range(len(gt)):
        meas = adapt_stereo(lefts[i], rights[i], acfg)
        slam.process(meas.points, meas.desc, meas.valid, 0.1 * i)
    slam.flush()
    ok, text, traj = _gates(slam, gt, rehearsal)
    if "chunked" not in out:
        return False, text + "; no chunked run to compare with"
    maps_c, closures_c, traj_c = out["chunked"]
    diff = _traj_diff(traj, traj_c)
    agree = (slam.num_maps == maps_c and slam.num_closures == closures_c
             and diff <= TRAJ_DIFF_TOL_M)
    return (ok and (agree or rehearsal)), (
        f"{text}; vs chunked: maps {slam.num_maps}/{maps_c} closures "
        f"{slam.num_closures}/{closures_c} max|dt|={diff:.4f} m "
        f"(tol {TRAJ_DIFF_TOL_M})")


def phase_kitti(rehearsal):
    import jax.numpy as jnp
    from srrg2_proslam_jax.io import datasets
    from srrg2_proslam_jax.models.frontend import (
        StereoAdaptorConfig, adapt_stereo,
    )
    from srrg2_proslam_jax.models.tracker import (
        TrackerConfig, initial_state, track_step,
    )
    from srrg2_proslam_jax.ops import se3

    frames = list(datasets.iter_bundled_kitti(
        os.path.join(REPO, "test_data"), "city"))
    cam = datasets.kitti_camera(*frames[0].left.shape)
    acfg, tcfg = StereoAdaptorConfig(), TrackerConfig()
    state = initial_state(capacity=4096)
    inliers = []
    for fr in frames:
        meas = adapt_stereo(jnp.asarray(fr.left), jnp.asarray(fr.right),
                            acfg)
        state, stats, _ = track_step(state, meas.points, meas.desc,
                                     meas.valid, cam, tcfg, "stereo")
        inliers.append(int(stats.num_inliers))
    t_err, ang = se3.error_t_and_angle(state.T_lm_robot,
                                       jnp.asarray(frames[-1].gt_pose))
    t_err = np.asarray(t_err)
    ok = bool(np.all(t_err <= np.array(KITTI_T_ERR_M))
              and float(ang) <= KITTI_ROT_RAD)
    return ok, (f"{len(frames)} frames {cam.cols}x{cam.rows}, inliers "
                f"{inliers}, final |t err|={np.round(t_err.astype(float), 4).tolist()} m "
                f"(gate {KITTI_T_ERR_M}) angle={float(ang):.4f} rad "
                f"(gate {KITTI_ROT_RAD})")


def phase_rgbd(rehearsal):
    import jax.numpy as jnp
    from srrg2_proslam_jax.io import datasets
    from srrg2_proslam_jax.io.quaternions import quaternion_to_rotation
    from srrg2_proslam_jax.models.frontend import (
        DepthAdaptorConfig, adapt_rgbd,
    )
    from srrg2_proslam_jax.models.slam import GraphSLAM, GraphSLAMConfig
    from srrg2_proslam_jax.ops import se3

    def pose(t, q_wxyz):
        T = np.eye(4, dtype=np.float32)
        w, x, y, z = q_wxyz
        T[:3, :3] = quaternion_to_rotation(np.array([x, y, z, w]))
        T[:3, 3] = t
        return T

    frames = list(datasets.iter_bundled_icl(
        os.path.join(REPO, "test_data")))[:2]
    slam = GraphSLAM(datasets.icl_camera(), GraphSLAMConfig(), model="rgbd")
    acfg = DepthAdaptorConfig()
    inliers, depth_median = [], None
    for i, fr in enumerate(frames):
        m = adapt_rgbd(jnp.asarray(fr.intensity), jnp.asarray(fr.depth),
                       acfg)
        if depth_median is None:
            d = np.asarray(m.points)[np.asarray(m.valid), 2]
            depth_median = float(np.median(d))
        inliers.append(int(slam.process(m.points, m.desc, m.valid,
                                        float(i)).num_inliers))
    # ground truth of the two frames (reference fixtures.hpp:597-615)
    gt = np.linalg.inv(pose([0.0, 0.0, -2.25], [1, 0, 0, 0])) @ pose(
        [0.000466347, 0.00895357, -2.24935],
        [0.999999, -0.00101358, 0.00052453, -0.000231475])
    traj = slam.trajectory()
    t_err, ang = se3.error_t_and_angle(
        jnp.asarray(slam.robot_in_world().astype(np.float32)),
        jnp.asarray(gt))
    t_err = np.asarray(t_err)
    ok = (all(np.all(np.isfinite(T)) for T in traj)
          and min(inliers[1:]) >= 6 and 2.0 <= depth_median <= 4.0
          and bool(np.all(t_err <= RGBD_T_ERR_M))
          and float(ang) <= RGBD_ROT_RAD)
    return ok, (f"{len(frames)} ICL frames, inliers {inliers} (>=6 after "
                f"frame 0), depth median {depth_median:.2f} m (2..4), "
                f"|t err|={np.round(t_err.astype(float), 5).tolist()} m (gate "
                f"{RGBD_T_ERR_M}) angle={float(ang):.5f} rad")


def phase_four_cards(loop, rehearsal):
    import jax
    from srrg2_proslam_jax.parallel import make_mesh

    devices = jax.devices()[:4]
    if len(devices) < 4:
        return False, f"needs 4 devices, found {len(jax.devices())}"
    runs = []
    for mesh in (make_mesh(devices), None):
        run_chunked(loop, rehearsal, mesh=mesh)            # compile
        t0 = time.perf_counter()
        slam = run_chunked(loop, rehearsal, mesh=mesh)
        runs.append((slam, time.perf_counter() - t0))
    (meshed, wall_m), (single, wall_s) = runs
    ok_m, text_m, traj_m = _gates(meshed, loop[3], rehearsal)
    ok_s, _, traj_s = _gates(single, loop[3], rehearsal)
    diff = _traj_diff(traj_m, traj_s)
    agree = (meshed.num_maps == single.num_maps
             and meshed.num_closures == single.num_closures
             and diff <= TRAJ_DIFF_TOL_M)
    return (ok_m and ok_s and (agree or rehearsal)), (
        f"4-card mesh: {text_m}; warm run {wall_m:.3f} s vs 1 card "
        f"{wall_s:.3f} s; maps {meshed.num_maps}/"
        f"{single.num_maps} closures {meshed.num_closures}/"
        f"{single.num_closures} max|dt|={diff:.4f} m "
        f"(tol {TRAJ_DIFF_TOL_M})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="phase 3 on a 4-card mesh vs one card, only")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny shapes on the CPU; no gates, no result")
    args = ap.parse_args()
    rehearsal = args.cpu_rehearsal

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not rehearsal:
        sys.exit(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}")
    sys.path.insert(0, REPO)
    from srrg2_proslam_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()              # sets nothing on the CPU
    if not rehearsal:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    else:
        smi = "not queried (CPU rehearsal)"
    print(smi, flush=True)

    phases = Phases()
    phases.run("1 device", phase_device, smi)
    loop = render_loop(rehearsal)
    if args.four_cards:
        phases.run("3 chunked SLAM, 4-card mesh vs 1 card",
                   phase_four_cards, loop, rehearsal)
        count = 4
    else:
        out = {}
        phases.run("2 kernels vs reference", phase_kernels, rehearsal)
        phases.run("3 chunked SLAM", phase_chunked, loop, rehearsal, out)
        phases.run("4 per-frame SLAM", phase_per_frame, loop, rehearsal,
                   out)
        phases.run("5 KITTI-width VO", phase_kitti, rehearsal)
        phases.run("6 RGB-D", phase_rgbd, rehearsal)
        count = 1
    if phases.failed:
        sys.exit(f"chip_smoke: failed phases: {phases.failed}")
    if rehearsal:
        return
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))


if __name__ == "__main__":
    main()
