"""Endurance system test: a 192-frame square loop with right-angle turns.

Exercises the full stack at once — dozens of local-map splits, turning
motion near the matcher's radius budget, loss recovery, loop closure and
PGO — the class of integration failure the short fixtures cannot catch
(a stale-velocity dead-reckoning bug found by this scenario produced 54 m
of drift before the LOST path reset the motion model).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from srrg2_proslam_jax.models.loop_closure import LoopDetectorConfig
from srrg2_proslam_jax.models.slam import (
    GraphSLAM, GraphSLAMConfig, SplittingConfig,
)
from srrg2_proslam_jax.metrics import trajectory as tm
from srrg2_proslam_jax.ops import se3
from tests.test_slam import CAM, _stereo_measurements


@pytest.mark.slow
def test_square_loop_endurance(rng):
    pts_w = np.stack([
        rng.uniform(-15, 25, 1500),
        rng.uniform(-5, 5, 1500),
        rng.uniform(-15, 25, 1500),
    ], 1).astype(np.float32)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(1500, 256))
    config = GraphSLAMConfig(
        splitting=SplittingConfig(maximum_translation_m=3.0,
                                  maximum_rotation_rad=0.5),
        loop=LoopDetectorConfig(minimum_age_difference=5, minimum_matches=25),
        arena_capacity=2048,
        database_capacity=65536,
        enable_loop_closing=True,
    )
    slam = GraphSLAM(CAM, config)
    T_wc = np.eye(4, dtype=np.float32)
    gt = []

    def advance(dz=0.0, dyaw=0.0):
        nonlocal T_wc
        M = np.asarray(se3.exp(jnp.asarray(
            np.array([0, 0, -dz, 0, dyaw, 0], np.float32))))
        T_wc = M @ T_wc

    frames = 0
    for _ in range(4):                       # 4 sides of a 10 m square
        for _ in range(25):
            p, d, ok = _stereo_measurements(pts_w, desc, T_wc)
            slam.process(p, d, ok, 0.1 * frames)
            frames += 1
            gt.append(np.linalg.inv(T_wc))
            advance(dz=0.4)
        for _ in range(23):                  # 90 deg turn, ~4 deg/frame
            p, d, ok = _stereo_measurements(pts_w, desc, T_wc)
            slam.process(p, d, ok, 0.1 * frames)
            frames += 1
            gt.append(np.linalg.inv(T_wc))
            advance(dyaw=np.pi / 2 / 23)

    traj = slam.trajectory()
    assert len(traj) == frames
    assert slam.num_maps > 10                # splits happened throughout
    errs = [np.linalg.norm(t[:3, 3] - g[:3, 3]) for t, g in zip(traj, gt)]
    # generous endurance bound: the stale-velocity bug produced ~23 m mean
    assert np.mean(errs) < 2.5, np.mean(errs)
    e = tm.evaluate(traj, gt)
    assert e.mean_rotation_deg < 15.0


@pytest.mark.slow
def test_capacity_lifecycle_grows_and_evicts(rng):
    """Tiny initial capacities on a long corridor: the pose graph must grow
    (double-and-copy) instead of crashing, the loop database must evict its
    oldest maps with closures still firing afterwards."""
    n_pts = 600
    pts_w = np.stack([
        rng.uniform(-15, 15, n_pts),
        rng.uniform(-5, 5, n_pts),
        rng.uniform(-5, 45, n_pts),      # corridor along +z
    ], 1).astype(np.float32)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(n_pts, 256))
    config = GraphSLAMConfig(
        splitting=SplittingConfig(maximum_translation_m=0.5),
        loop=LoopDetectorConfig(minimum_age_difference=3, minimum_matches=25),
        arena_capacity=1024,
        max_local_maps=4,                # force growth: the run needs ~50
        max_edges=4,
        database_capacity=2048,          # force eviction
        max_db_descriptors_per_map=128,
        enable_loop_closing=True,
    )
    slam = GraphSLAM(CAM, config)
    # out 14 m and back: ~28 maps out (0.5 m splits), closures on the return
    zs = list(np.arange(0, 14.0, 0.25)) + list(np.arange(14.0, -0.01, -0.25))
    for i, z in enumerate(zs):
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[2, 3] = -z
        p, d, ok = _stereo_measurements(pts_w, desc, T_wc)
        slam.process(p, d, ok, timestamp=0.1 * i)

    assert slam.num_maps > 20                  # grew far past max_local_maps=4
    assert slam.graph.capacity >= slam.num_maps
    assert slam.num_edges > 4                  # edge growth too
    assert slam.num_db_evictions > 0           # database eviction kicked in
    assert slam.num_closures >= 1              # closures still fire after it
    traj = slam.trajectory()
    assert len(traj) == len(zs)
    assert np.linalg.norm(traj[-1][:3, 3]) < 1.0


@pytest.mark.slow
def test_chunked_device_memory_bounded(rng):
    """Chunked mode across ~60 splits: mirrors must not pin whole chunk
    outputs, and finalized-map arenas beyond ``max_device_map_arenas`` must
    spill to host — with relocalization into a spilled map still working
    (VERDICT r4 item 2).

    The reference keeps every local map in process RAM for the whole run
    (app_benchmark.cpp:136-169); the chunked orchestrator instead keeps
    a bounded device cache and reloads through the host store.
    """
    import gc
    import jax

    from tests.test_speculation import _frames_out_and_back

    frames = _frames_out_and_back(rng, n_out=40, step_z=0.4)  # 80 frames
    config = GraphSLAMConfig(
        splitting=SplittingConfig(maximum_translation_m=0.5),
        loop=LoopDetectorConfig(minimum_age_difference=1),
        arena_capacity=1024,
        max_local_maps=128,
        max_edges=512,
        database_capacity=8192,
        max_db_descriptors_per_map=128,
        enable_loop_closing=True,
        chunk_size=8,
        max_device_map_arenas=2,
    )
    slam = GraphSLAM(CAM, config)
    pts = jnp.stack([f[0] for f in frames])
    desc = jnp.stack([f[1] for f in frames])
    ok = jnp.stack([f[2] for f in frames])
    gc.collect()
    base_bytes = sum(int(x.nbytes) for x in jax.live_arrays())

    slam.process_meas_sequence(pts, desc, ok,
                               [0.1 * i for i in range(len(frames))])
    slam.flush()
    # barrier: the spill worker has executed every queued spill
    slam._spiller.submit(lambda: None).result()
    gc.collect()

    assert slam.num_maps >= 50                 # splits happened throughout
    assert slam.num_relocalizations >= 1       # reloads a SPILLED old map
    # structural bound: at most the cache quota (+ the current map) stays
    # device-resident; everything older is numpy (or a resolved future)
    device_resident = [
        mid for mid, v in slam._map_arenas.items()
        if not hasattr(v, "result")
        and not (hasattr(v, "pos") and isinstance(v.pos, np.ndarray))
    ]
    assert len(device_resident) <= config.max_device_map_arenas + 1, \
        device_resident
    # no mirror may reference a whole-chunk output: stack slices hold at
    # most chunk_size frames and are themselves spilled once beyond the LRU
    # byte bound: sequence + graph + db + <=3 arenas + stacks; unbounded
    # lazy chunk pinning measured ~5x this margin on the same run
    grown = sum(int(x.nbytes) for x in jax.live_arrays()) - base_bytes
    per_arena = sum(int(np.asarray(getattr(slam.tracker_state.arena, f)).nbytes)
                    for f in ("pos", "cov", "desc", "num_updates", "valid"))
    assert grown < 12 * per_arena + 8 * 1024 * 1024, (grown, per_arena)
