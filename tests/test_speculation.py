"""Speculative pipeline equivalence: deferred consumption == synchronous.

The orchestrator's speculative mode (GraphSLAMConfig.speculation_depth > 0)
dispatches frames without blocking and consumes the status packets several
frames behind, rolling back and replaying on split/lost mispredicts
(models/slam.py).  Because rollback restores the exact post-frame tracker
state and replays the identical measurement stream, the end state must be
IDENTICAL to the synchronous mode — these tests pin that invariant on runs
that exercise splits, losses, loop closures, and relocalization.
"""
import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.models.loop_closure import LoopDetectorConfig
from srrg2_proslam_jax.models.slam import (
    GraphSLAM, GraphSLAMConfig, SplittingConfig,
)
from srrg2_proslam_jax.models.tracker import TrackerConfig
from srrg2_proslam_jax.ops import se3
from tests.test_slam import CAM, _stereo_measurements, _world


def _drive(slam, frames):
    for i, (p, d, ok) in enumerate(frames):
        slam.process(p, d, ok, timestamp=0.1 * i)
    slam.flush()
    return slam


def _frames_linear(rng, n_frames, step_z=0.4, lose_at=()):
    """Forward run; frames listed in ``lose_at`` carry no valid points."""
    pts_w = _world(rng)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(pts_w.shape[0], 256))
    frames = []
    T_wc = np.eye(4, dtype=np.float32)
    for i in range(n_frames):
        p, d, ok = _stereo_measurements(pts_w, desc, T_wc)
        if i in lose_at:
            ok = jnp.zeros_like(ok)
        frames.append((p, d, ok))
        T_step = np.asarray(se3.exp(jnp.asarray(
            np.array([0, 0, -step_z, 0, 0, 0], np.float32))))
        T_wc = T_step @ T_wc
    return frames


def _frames_out_and_back(rng, n_out=10, step_z=0.5):
    """Out along +z then back to the start: triggers a relocalization."""
    pts_w = _world(rng, n=600)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(pts_w.shape[0], 256))
    frames = []
    T_wc = np.eye(4, dtype=np.float32)
    steps = [-step_z] * n_out + [step_z] * n_out
    for dz in steps:
        p, d, ok = _stereo_measurements(pts_w, desc, T_wc)
        frames.append((p, d, ok))
        T_step = np.asarray(se3.exp(jnp.asarray(
            np.array([0, 0, dz, 0, 0, 0], np.float32))))
        T_wc = T_step @ T_wc
    return frames


def _config(depth, loop=False):
    return GraphSLAMConfig(
        tracker=TrackerConfig(),
        splitting=SplittingConfig(maximum_translation_m=1.2),
        loop=LoopDetectorConfig(minimum_age_difference=1),
        arena_capacity=1024,
        database_capacity=8192,
        max_db_descriptors_per_map=512,
        enable_loop_closing=loop,
        speculation_depth=depth,
    )


def _assert_equivalent(a, b):
    assert a.num_maps == b.num_maps
    assert a.num_closures == b.num_closures
    assert a.num_relocalizations == b.num_relocalizations
    assert len(a.frames) == len(b.frames)
    ta = np.stack(a.trajectory())
    tb = np.stack(b.trajectory())
    np.testing.assert_allclose(ta, tb, atol=1e-5)
    assert [f.local_map_index for f in a.frames] == \
        [f.local_map_index for f in b.frames]


def test_speculation_matches_sync_on_splits(rng):
    frames = _frames_linear(rng, n_frames=14)
    sync = _drive(GraphSLAM(CAM, _config(0)), frames)
    spec = _drive(GraphSLAM(CAM, _config(6)), frames)
    assert sync.num_maps >= 3  # the run must actually split
    _assert_equivalent(sync, spec)


def test_speculation_matches_sync_on_loss(rng):
    frames = _frames_linear(rng, n_frames=12, lose_at=(5,))
    sync = _drive(GraphSLAM(CAM, _config(0)), frames)
    spec = _drive(GraphSLAM(CAM, _config(4)), frames)
    _assert_equivalent(sync, spec)


def test_speculation_matches_sync_on_relocalization(rng):
    frames = _frames_out_and_back(rng)
    sync = _drive(GraphSLAM(CAM, _config(0, loop=True)), frames)
    spec = _drive(GraphSLAM(CAM, _config(5, loop=True)), frames)
    assert sync.num_relocalizations >= 1  # the run must actually reload
    _assert_equivalent(sync, spec)


def test_flush_idempotent(rng):
    frames = _frames_linear(rng, n_frames=6)
    slam = _drive(GraphSLAM(CAM, _config(4)), frames)
    n = len(slam.frames)
    slam.flush()
    slam.flush()
    assert len(slam.frames) == n
