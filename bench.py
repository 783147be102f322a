"""Benchmark: FULL GraphSLAM.process loop on a rendered closed-loop sequence.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Metric definition mirrors the reference's mean_frame_hz — processed messages
divided by summed per-message compute time over the WHOLE pipeline: adaptor,
tracker, splits, loop closure, relocalization and PGO all inside the timed
loop (reference srrg2_proslam/apps/app_benchmark.cpp:350-366 measures its
full compute() the same way).  Frames are the rendered closed-loop stereo
sequence (io/synthetic.py) pre-rendered to device so the loop measures SLAM
compute, not synthesis.

The headline number is the PRODUCTION configuration: chunked stepping
(GraphSLAMConfig.chunk_size > 0, models/chunk.py) in which B frames AND
their split pipelines run in one device program per chunk and the host
reads one packet per chunk.  The speculative and synchronous per-frame
numbers go to stderr as diagnostics, as do amortized device times
(hundreds of frames inside one executable) and the tracker step's FLOPs.

The baseline divisor is the reference CI target regime (an unspecified CPU;
the original ProSLAM paper reports well-above-real-time on desktop CPUs, so
100 Hz is used as the reference-class anchor until a measured C++ number
exists).
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from srrg2_proslam_jax.io import datasets
from srrg2_proslam_jax.io import synthetic as syn
from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig, adapt_stereo
from srrg2_proslam_jax.models.loop_closure import LoopDetectorConfig
from srrg2_proslam_jax.models.slam import (
    GraphSLAM, GraphSLAMConfig, SplittingConfig,
)
from srrg2_proslam_jax.models.tracker import (
    TrackerConfig, initial_state, track_step,
)
from srrg2_proslam_jax.utils import profiling
from srrg2_proslam_jax.utils.compile_cache import enable_compile_cache

REFERENCE_FRAME_HZ = 100.0  # reference-class CPU anchor (see module docstring)

_err = lambda *a: print(*a, file=sys.stderr, flush=True)


def _render_sequence(n_frames):
    """Pre-render the closed-loop stereo sequence; images stay ON DEVICE."""
    cam = syn.synthetic_camera()
    planes = syn.make_room(size_x=22.0, size_z=32.0)
    poses = syn.loop_trajectory()[:n_frames]
    images = []
    for T in poses:
        left, right, _ = syn.render_stereo(cam, jnp.asarray(T), planes)
        images.append((left, right))
    jax.block_until_ready(images[-1])
    return cam, images


def _slam_config(speculation_depth=0, chunk_size=0):
    return GraphSLAMConfig(
        # production posture: GN bursts terminate on convergence
        # (SimpleTerminationCriteria analog; trades cross-mode
        # bit-equivalence for latency — see TrackerConfig.gn_epsilon)
        tracker=TrackerConfig(gn_epsilon=1e-5),
        splitting=SplittingConfig(maximum_translation_m=5.0,
                                  maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=5),
        # per-dataset capacity sizing (the reference's own practice: its
        # configs pin maximum landmark pools per dataset): the rendered
        # scene's maps peak at ~520 landmarks (scripts-measured), so 2048
        # keeps 4x headroom while halving the tracker matmuls, the EKF
        # batch, and the split-time query rows vs the 4096 default
        arena_capacity=2048,
        database_capacity=16384,
        max_db_descriptors_per_map=512,
        # pose-graph capacity sized to the run (23 maps + in-flight
        # headroom; the orchestrator grows double-and-copy if exceeded):
        # the dense PGO solve is a [6N, 6N] LU at FULL capacity, and it
        # runs inside the closure-accepting chunk AND the backstop loop,
        # so capacity slack costs time on every closure
        max_local_maps=128,
        max_edges=512,
        speculation_depth=speculation_depth,
        chunk_size=chunk_size,
    )


def run_full_loop(cam, images, acfg, depth):
    """One full SLAM pass (per-frame pipeline); returns (elapsed_s, slam)."""
    slam = GraphSLAM(cam, _slam_config(speculation_depth=depth),
                     model="stereo")
    t0 = time.perf_counter()
    for i, (left, right) in enumerate(images):
        meas = adapt_stereo(left, right, acfg)
        slam.process(meas.points, meas.desc, meas.valid, 0.1 * i)
    slam.flush()
    jax.block_until_ready(slam.tracker_state.T_lm_robot)
    return time.perf_counter() - t0, slam


def run_chunked(cam, left_all, right_all, acfg, chunk_size):
    """One full SLAM pass in chunked mode (models/chunk.py)."""
    slam = GraphSLAM(cam, _slam_config(chunk_size=chunk_size),
                     model="stereo")
    n = int(left_all.shape[0])
    t0 = time.perf_counter()
    slam.process_sequence(left_all, right_all,
                          [0.1 * i for i in range(n)], acfg)
    jax.block_until_ready(slam.tracker_state.T_lm_robot)
    return time.perf_counter() - t0, slam


def tracker_only_hz(acfg, tcfg):
    """Round-1 continuity metric: steady-state adaptor+tracker on bundled
    KITTI frames (device-resident inputs, no host logic)."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "test_data")
    frames = list(datasets.iter_bundled_kitti(root, "city"))
    cam = datasets.kitti_camera(*frames[0].left.shape)
    images = [(jnp.asarray(f.left), jnp.asarray(f.right)) for f in frames]
    state = initial_state(4096)
    for left, right in images:  # warmup + map population
        meas = adapt_stereo(left, right, acfg)
        state, stats, X = track_step(
            state, meas.points, meas.desc, meas.valid, cam, tcfg, "stereo")
    jax.block_until_ready(state.T_lm_robot)
    n_reps, count = 8, 0
    t0 = time.perf_counter()
    for _ in range(n_reps):
        for left, right in images:
            meas = adapt_stereo(left, right, acfg)
            state, stats, X = track_step(
                state, meas.points, meas.desc, meas.valid, cam, tcfg,
                "stereo")
            count += 1
    jax.block_until_ready(state.T_lm_robot)
    return count / (time.perf_counter() - t0)


def amortized_device_times(cam, left_all, right_all, acfg, tcfg,
                           B=16, reps=32):
    """Device cost per frame, amortized over one executable.

    ``reps`` repetitions of the B-frame frontend+tracker pipeline run
    inside ONE executable (a lax.scan threading the tracker state, so no
    iteration can be hoisted or overlapped away), the single result read
    surfaces the whole computation, and wall / (reps*B) amortizes the one
    dispatch+readback over all frames.  Mirrors the reference's
    PROFILE_TIME per-stage discipline
    (raw_data_preprocessor_stereo_projective.cpp:47-98) at device
    granularity.  Returns (t_frame, t_tracker, t_adaptor, flops_per_step).
    """
    from srrg2_proslam_jax.models.frontend import adapt_stereo_batch

    a = left_all[:B]
    b = right_all[:B]

    def track_frames(state, pts, desc, valid):
        def body(st, xs):
            p, d, v = xs
            st2, stats, _ = track_step(st, p, d, v, cam, tcfg, "stereo")
            return st2, stats.num_inliers
        return jax.lax.scan(body, state, (pts, desc, valid))[0]

    @jax.jit
    def populate(state, a, b):
        meas = adapt_stereo_batch(a, b, acfg)
        return track_frames(state, meas.points, meas.desc, meas.valid)

    @jax.jit
    def tracker_rep(state, pts, desc, valid):
        def body(st, _):
            return track_frames(st, pts, desc, valid), None
        st, _ = jax.lax.scan(body, state, None, length=reps)
        return st.T_lm_robot

    @jax.jit
    def pipeline_rep(state, a, b):
        def body(st, i):
            # the (i & 1) pixel perturbation forges a loop-carried data
            # dependence so XLA cannot hoist the adaptor out of the scan
            ai = a + (i & 1).astype(a.dtype)
            meas = adapt_stereo_batch(ai, b, acfg)
            return track_frames(st, meas.points, meas.desc, meas.valid), None
        st, _ = jax.lax.scan(body, state,
                             jnp.arange(reps, dtype=jnp.int32))
        return st.T_lm_robot

    meas0 = jax.jit(lambda a, b: adapt_stereo_batch(a, b, acfg))(a, b)
    state = populate(initial_state(2048), a, b)
    np.asarray(state.T_lm_robot)  # settle before timing

    def timed(fn, *args):
        np.asarray(fn(*args))     # compile
        t0 = time.perf_counter()
        np.asarray(fn(*args))     # ONE executable; the read consumes it
        return (time.perf_counter() - t0) / (reps * B)

    t_tracker = timed(tracker_rep, state, meas0.points, meas0.desc,
                      meas0.valid)
    t_frame = timed(pipeline_rep, state, a, b)
    t_adaptor = max(t_frame - t_tracker, 0.0)

    flops = None
    try:
        # FLOPs from the SINGLE-step lowering (XLA's cost analysis counts a
        # scan body once, so dividing the rep-op's count misreports)
        p0 = jax.tree_util.tree_map(lambda x: x[0], meas0)
        cost = jax.jit(
            lambda s, p, d, v: track_step(s, p, d, v, cam, tcfg, "stereo")
        ).lower(state, p0.points, p0.desc, p0.valid).compile().cost_analysis()
        if cost:
            cost = cost[0] if isinstance(cost, (list, tuple)) else cost
            flops = float(cost.get("flops", 0.0))
    except Exception as e:  # cost analysis is best-effort per backend
        _err(f"cost_analysis unavailable: {e}")
    return t_frame, t_tracker, t_adaptor, flops


def main():
    enable_compile_cache()
    acfg = StereoAdaptorConfig()
    tcfg = TrackerConfig()
    n_frames = int(os.environ.get("BENCH_FRAMES", "253"))
    depth = int(os.environ.get("BENCH_SPECULATION_DEPTH", "12"))
    chunk = int(os.environ.get("BENCH_CHUNK_SIZE", "16"))

    _err(f"rendering {n_frames} closed-loop frames on device ...")
    cam, images = _render_sequence(n_frames)
    left_all = jnp.stack([im[0] for im in images])
    right_all = jnp.stack([im[1] for im in images])

    # warmup pass compiles every stage (chunk op, splits, loop query, PGO)
    run_chunked(cam, left_all, right_all, acfg, chunk)

    # headline: production (chunked) configuration, median of 3 runs
    times = []
    for _ in range(3):
        dt, slam_c = run_chunked(cam, left_all, right_all, acfg, chunk)
        times.append(dt)
    hz_chunk = n_frames / float(np.median(times))

    profiling.enable()
    profiling.reset()
    run_chunked(cam, left_all, right_all, acfg, chunk)
    report = profiling.report()
    profiling.enable(False)

    # diagnostics: per-frame pipelines (speculative + synchronous)
    run_full_loop(cam, images, acfg, depth)  # warmup per-frame jits
    dt_spec, slam_p = run_full_loop(cam, images, acfg, depth)
    hz_spec = n_frames / dt_spec
    dt_sync, slam_s = run_full_loop(cam, images, acfg, 0)
    hz_sync = n_frames / dt_sync

    _err(f"full-loop chunked (B={chunk}):      {hz_chunk:8.1f} frames/s "
         f"({slam_c.num_maps} maps, {slam_c.num_closures} closures, "
         f"{slam_c.num_relocalizations} relocs; reloc recovery: "
         f"{slam_c.num_reloc_rollbacks} rollbacks / "
         f"{slam_c.num_reloc_replays} replays)")
    _err(f"full-loop speculative (depth {depth}): {hz_spec:8.1f} frames/s "
         f"({slam_p.num_maps} maps, {slam_p.num_closures} closures)")
    _err(f"full-loop synchronous (depth 0):  {hz_sync:8.1f} frames/s "
         f"({slam_s.num_maps} maps, {slam_s.num_closures} closures)")
    _err(report)

    t_frame, t_track, t_adapt, flops = amortized_device_times(
        cam, left_all, right_all, acfg, tcfg)
    _err(f"device time (amortized, 512 frames per executable): "
         f"frame pipeline {t_frame * 1e3:.2f} ms = adaptor "
         f"{t_adapt * 1e3:.2f} + tracker {t_track * 1e3:.2f} ms/frame")
    if flops:
        _err(f"tracker step: {flops / 1e9:.2f} GFLOP -> "
             f"{flops / t_track / 1e12:.2f} TFLOP/s achieved")
    hz_tracker = tracker_only_hz(acfg, tcfg)
    _err(f"tracker-only steady-state (round-1 metric): {hz_tracker:.1f} "
         f"frames/s on bundled KITTI")

    print(json.dumps({
        "metric": "mean_frame_hz",
        "value": round(hz_chunk, 2),
        "unit": "frames/s",
        "vs_baseline": round(hz_chunk / REFERENCE_FRAME_HZ, 3),
        # amortized per-frame device cost measured inside ONE executable
        "device_ms_per_frame": round(t_frame * 1e3, 3),
        "device_ms_adaptor": round(t_adapt * 1e3, 3),
        "device_ms_tracker": round(t_track * 1e3, 3),
    }))


if __name__ == "__main__":
    main()
