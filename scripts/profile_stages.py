"""Device timings of the frame pipeline's stages and kernels on the GPU.

Each stage is jitted, warmed up, and called ``--reps`` times; every call
ends in ``block_until_ready`` and the printed figure is the median per
call.  The GN burst variants run as a ``lax.scan`` of bursts inside one
program, so the launch and predicate-sync gaps between a burst's kernels
count and host dispatch does not.  Rates are divided by the H100 SXM's
published HBM bandwidth (3.35 TB/s, NVIDIA data sheet).

``--sections e2e`` times the bench.py chunked headline end to end with
the fused GN kernel on and off (interleaved, median of 3 each); ``--trace``
traces one headline run and prints the device's busy share and heaviest
kernels.

Run: python scripts/profile_stages.py [--reps N] [--sections fast,gn,...]
                                     [--trace DIR]
"""
import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import jax
import jax.numpy as jnp

from srrg2_proslam_jax.utils.compile_cache import enable_compile_cache

HBM_BYTES_PER_S = 3.35e12


def timed(label, fn, *args, reps, per=1, note=""):
    """Median wall time of ``fn(*args)`` per call (divided by ``per``)."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times) / per
    print(f"{label:52s} {dt * 1e6:10.1f} us {note}", flush=True)
    return dt


def profile_fast(F, reps):
    cfg = F.FeatureExtractorConfig()
    for B, H, W in ((32, 480, 640), (2, 376, 1241)):
        imgs = jax.random.uniform(jax.random.PRNGKey(0), (B, H, W)) * 255
        bound = 2 * B * H * W * 4 / HBM_BYTES_PER_S
        fn = jax.jit(lambda x: F.fast_scores(x, cfg.detector_threshold))
        temp = fn.lower(imgs).compile().memory_analysis().temp_size_in_bytes
        dt = timed(f"fast_scores B={B} {H}x{W}", fn, imgs, reps=reps)
        print(f"  temp {temp / 1e6:.1f} MB; share of the HBM bound "
              f"({bound * 1e6:.1f} us): {bound / dt:.3f}")
        det = jax.jit(lambda x: F.detect_keypoints_batch(x, cfg))
        timed(f"detect_keypoints_batch B={B} {H}x{W}", det, imgs, reps=reps)
        feats = jax.jit(lambda x: F.extract_features_batch(x, cfg))
        timed(f"extract_features_batch B={B} {H}x{W}", feats, imgs,
              reps=reps)


def profile_gn(reps):
    from srrg2_proslam_jax.io.datasets import kitti_camera
    from srrg2_proslam_jax.io.synthetic import synthetic_camera
    from srrg2_proslam_jax.ops import gn, se3
    from srrg2_proslam_jax.ops.gn_pallas import gn_burst_stereo

    n_bursts, C = 64, 1152
    for cam in (synthetic_camera(), kitti_camera()):
        rng = np.random.RandomState(0)
        pts = np.stack([rng.uniform(-8, 8, C), rng.uniform(-3, 3, C),
                        rng.uniform(4, 40, C)], 1).astype(np.float32)
        X_gt = se3.exp(jnp.asarray([0.05, -0.02, 0.3, 0.01, -0.02, 0.005]))
        p = np.asarray(se3.transform_points(X_gt, jnp.asarray(pts)))
        u = cam.fx * p[:, 0] / p[:, 2] + cam.cx
        meas = np.stack([u, cam.fy * p[:, 1] / p[:, 2] + cam.cy,
                         u - cam.baseline_px / p[:, 2]], 1)
        meas += rng.normal(0, 0.5, meas.shape)
        args = (jnp.asarray(pts), jnp.asarray(meas, jnp.float32),
                jnp.ones(C, jnp.float32), jnp.arange(C) < 1000)
        for eps in (0.0, 1e-5):
            def xla(unroll, X, pts, meas, w, mask):
                system = lambda Xc: gn.stereo_projective_system(
                    Xc, pts, meas, w, mask, cam, 25.0)
                return gn.gn_iterate(system, X, 5, epsilon=eps,
                                     unroll=unroll)

            variants = {
                "while_loop": lambda *a: xla(False, *a),
                "unrolled": lambda *a: xla(True, *a),
                "kernel": lambda X, *a: gn_burst_stereo(
                    X, *a, cam=cam, iterations=5, epsilon=eps),
            }
            for name, burst in variants.items():
                @jax.jit
                def chain(X0, *a, burst=burst):
                    def body(X, _):
                        # restart each burst from a perturbed estimate so
                        # every burst iterates like a fresh frame
                        Xn, stats = burst(X, *a)
                        return X0 @ se3.inverse(Xn) @ Xn, stats.num_inliers
                    return jax.lax.scan(body, X0, None, length=n_bursts)
                timed(f"GN burst {name:10s} eps={eps:g} "
                      f"{cam.cols}x{cam.rows}", chain, se3.identity(), *args,
                      reps=reps, per=n_bursts)


def profile_hamming():
    from srrg2_proslam_jax.ops.hamming import distance_matrix

    a = jnp.ones((1152, 256), jnp.int8)
    b = jnp.ones((16384, 256), jnp.int8)
    hlo = jax.jit(distance_matrix).lower(a, b).compile().as_text()
    gemm = [ln.strip()[:160] for ln in hlo.splitlines()
            if "custom_call_target" in ln or "__cublas" in ln]
    print("hamming [1152x256] x [16384x256]^T lowers to:",
          gemm if gemm else "no library GEMM (XLA fusion)")
    timed("hamming distance_matrix 1152 x 16384", jax.jit(distance_matrix),
          a, b, reps=20)


def profile_pipeline(reps):
    from srrg2_proslam_jax.io import synthetic as syn
    from srrg2_proslam_jax.models.frontend import (
        StereoAdaptorConfig, adapt_stereo, adapt_stereo_batch,
    )
    from srrg2_proslam_jax.models.tracker import (
        TrackerConfig, initial_state, track_step,
    )

    cam = syn.synthetic_camera()
    planes = syn.make_room(size_x=22.0, size_z=32.0)
    poses = syn.loop_trajectory()[:16]
    imgs = [syn.render_stereo(cam, jnp.asarray(T), planes)[:2] for T in poses]
    lefts = jnp.stack([i[0] for i in imgs])
    rights = jnp.stack([i[1] for i in imgs])
    acfg = StereoAdaptorConfig()
    timed("adapt_stereo_batch B=16 480x640",
          jax.jit(lambda a, b: adapt_stereo_batch(a, b, acfg)), lefts,
          rights, reps=reps, per=16, note="(per frame)")
    meas = adapt_stereo(lefts[0], rights[0], acfg)
    for gn_pallas in (False, True):
        tcfg = TrackerConfig(gn_epsilon=1e-5, gn_pallas=gn_pallas)
        state = initial_state(2048)
        state, _, _ = track_step(state, meas.points, meas.desc, meas.valid,
                                 cam, tcfg, "stereo")
        timed(f"track_step gn_pallas={gn_pallas}",
              lambda s: track_step(s, meas.points, meas.desc, meas.valid,
                                   cam, tcfg, "stereo")[0].T_lm_robot,
              state, reps=reps)


def _chunked_headline():
    """``once(config, acfg)`` runs the bench.py chunked headline once."""
    import bench
    from srrg2_proslam_jax.models.slam import GraphSLAM

    cam, images = bench._render_sequence(253)
    lefts = jnp.stack([im[0] for im in images])
    rights = jnp.stack([im[1] for im in images])

    def once(config, acfg):
        slam = GraphSLAM(cam, config, model="stereo")
        t0 = time.perf_counter()
        slam.process_sequence(lefts, rights,
                              [0.1 * i for i in range(len(images))], acfg)
        jax.block_until_ready(slam.tracker_state.T_lm_robot)
        return time.perf_counter() - t0, slam

    return once, len(images)


def profile_e2e(runs=3):
    """Chunked headline with the fused GN kernel on and off, interleaved."""
    import bench
    from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig
    from srrg2_proslam_jax.utils import config as cfg

    once, n = _chunked_headline()
    base, acfg = bench._slam_config(chunk_size=16), StereoAdaptorConfig()
    configs = {flag: cfg.replace(base, tracker=cfg.replace(
        base.tracker, gn_pallas=flag)) for flag in (True, False)}
    times = {flag: [] for flag in configs}
    for config in configs.values():
        once(config, acfg)                          # compile
    for r in range(runs):
        for flag in ((True, False) if r % 2 == 0 else (False, True)):
            dt, slam = once(configs[flag], acfg)
            times[flag].append(dt)
            print(f"  chunked headline gn_pallas={flag}: {dt:.3f} s "
                  f"({n / dt:.1f} frames/s, {slam.num_maps} maps, "
                  f"{slam.num_closures} closures)", flush=True)
    for flag, ts in times.items():
        med = statistics.median(ts)
        print(f"chunked headline gn_pallas={flag}: median {med:.3f} s = "
              f"{n / med:.1f} frames/s over {runs} runs "
              f"{[round(t, 3) for t in ts]}", flush=True)


def reduce_trace(trace_dir, window_s):
    """Device busy share and the heaviest kernels of a jax.profiler trace."""
    import glob
    from collections import defaultdict

    path = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                         "*", "*.xplane.pb")))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = [ln for ln in plane.lines if ln.name.startswith("Stream")]
        spans, per_op = [], defaultdict(lambda: [0, 0.0])
        for ln in lines:
            for ev in ln.events:
                spans.append((ev.start_ns, ev.end_ns))
                per_op[ev.name][0] += 1
                per_op[ev.name][1] += ev.duration_ns
        spans.sort()
        busy, end = 0, None
        for a, b in spans:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        print(f"{plane.name}: busy {busy / 1e6:.1f} ms of a "
              f"{window_s * 1e3:.1f} ms window (idle share "
              f"{1 - busy / 1e9 / window_s:.3f}); {len(spans)} kernels")
        for name, (n, ns) in sorted(per_op.items(),
                                    key=lambda kv: -kv[1][1])[:20]:
            print(f"  {ns / 1e6:8.2f} ms {n:6d}x  {name[:90]}")


def profile_trace(trace_dir):
    """Trace one warm chunked-headline run and reduce it."""
    import bench

    from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig

    once, _ = _chunked_headline()
    args = (bench._slam_config(chunk_size=16), StereoAdaptorConfig())
    once(*args)                                     # compile
    with jax.profiler.trace(trace_dir):
        dt, _ = once(*args)
    reduce_trace(trace_dir, dt)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--sections", default="fast,gn,hamming,pipeline,e2e")
    ap.add_argument("--trace", default=None,
                    help="trace one chunked-headline run into this dir")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, found {dev.platform}")
    enable_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {dev.device_kind} x{len(jax.devices())}; {smi}")
    from srrg2_proslam_jax.ops import features as F

    sections = {
        "fast": lambda: profile_fast(F, args.reps),
        "gn": lambda: profile_gn(args.reps),
        "hamming": profile_hamming,
        "pipeline": lambda: profile_pipeline(args.reps),
        "e2e": profile_e2e,
    }

    for name in filter(None, args.sections.split(",")):
        sections[name]()
    if args.trace:
        profile_trace(args.trace)


if __name__ == "__main__":
    main()
