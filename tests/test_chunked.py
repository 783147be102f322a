"""Chunked-mode equivalence: B frames per device program == per-frame loop.

models/chunk.py moves the adaptor, tracker, AND the status machine
(Initializing/Tracking/Lost + the viewpoint splitting criterion) into one
device program per chunk, with the split-time pipeline (db insert, loop
query/validation, closure factors, PGO, makeNewMap) fused into a second
single dispatch.  Frame-level math is the same track_step, so the end state
must match the synchronous per-frame orchestrator exactly — pinned here on
runs that exercise splits, losses, loop closures, and relocalization.
"""
import numpy as np
import pytest
import jax.numpy as jnp

from srrg2_proslam_jax.models.loop_closure import LoopDetectorConfig
from srrg2_proslam_jax.models.slam import (
    GraphSLAM, GraphSLAMConfig, SplittingConfig,
)
from srrg2_proslam_jax.models.tracker import TrackerConfig
from tests.test_slam import CAM
from tests.test_speculation import (
    _frames_linear, _frames_out_and_back,
)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jit_caches():
    """Drop all cached executables before this module.

    XLA:CPU segfaults sporadically inside backend compilation once a single
    process has accumulated several hundred compiled programs (observed
    twice at exactly this point of the full suite, jax 0.9.0; the same
    tests pass standalone).  Clearing the jit caches bounds the live
    executable count at the cost of a few re-compilations."""
    import jax

    jax.clear_caches()
    yield



def _config(chunk, loop=False, group=1):
    return GraphSLAMConfig(
        tracker=TrackerConfig(),
        splitting=SplittingConfig(maximum_translation_m=1.2),
        loop=LoopDetectorConfig(minimum_age_difference=1),
        arena_capacity=1024,
        database_capacity=8192,
        max_db_descriptors_per_map=512,
        enable_loop_closing=loop,
        chunk_size=chunk,
        chunk_group=group,
    )


def _drive_perframe(frames, loop=False):
    slam = GraphSLAM(CAM, _config(0, loop))
    for i, (p, d, ok) in enumerate(frames):
        slam.process(p, d, ok, timestamp=0.1 * i)
    slam.flush()
    return slam


def _drive_chunked(frames, chunk, loop=False, group=1):
    slam = GraphSLAM(CAM, _config(chunk, loop, group))
    pts = jnp.stack([f[0] for f in frames])
    desc = jnp.stack([f[1] for f in frames])
    valid = jnp.stack([f[2] for f in frames])
    slam.process_meas_sequence(pts, desc, valid,
                               [0.1 * i for i in range(len(frames))])
    return slam


def _assert_equivalent(a, b):
    assert a.num_maps == b.num_maps
    assert a.num_closures == b.num_closures
    assert a.num_relocalizations == b.num_relocalizations
    assert len(a.frames) == len(b.frames)
    assert [f.local_map_index for f in a.frames] == \
        [f.local_map_index for f in b.frames]
    ta = np.stack(a.trajectory())
    tb = np.stack(b.trajectory())
    np.testing.assert_allclose(ta, tb, atol=1e-5)


def test_chunked_matches_perframe_on_splits(rng):
    frames = _frames_linear(rng, n_frames=14)
    ref = _drive_perframe(frames)
    assert ref.num_maps >= 3  # the run must actually split
    for chunk in (4, 5, 16):  # aligned, straddling, single-chunk
        _assert_equivalent(ref, _drive_chunked(frames, chunk))


def test_chunked_matches_perframe_on_loss(rng):
    frames = _frames_linear(rng, n_frames=12, lose_at=(5,))
    ref = _drive_perframe(frames)
    _assert_equivalent(ref, _drive_chunked(frames, 4))


def test_chunked_matches_perframe_with_closures(rng):
    frames = _frames_out_and_back(rng)
    ref = _drive_perframe(frames, loop=True)
    assert ref.num_relocalizations >= 1  # exercises the chunk rollback
    _assert_equivalent(ref, _drive_chunked(frames, 4, loop=True))
    _assert_equivalent(ref, _drive_chunked(frames, 8, loop=True))


def test_reloc_rollback_avoids_replay(rng):
    """A relocalization whose chunk contains a LATER finish must recover
    the at-finish carry by the device ROLLBACK (undo the later finish's
    pose/edge/db-slot/counters), not the full-chunk replay — and stay
    bit-equivalent to the per-frame orchestrator.  The replay remains the
    fallback only for closure-bearing later finishes (PGO pose rewrites
    are not invertible).

    Scenario: out-and-back triggers the reloc on the return path; the
    blank frame shortly after forces a LOST finish in the same chunk's
    pre-reloc rollout (lost finishes never run the closure query, so the
    later finish is guaranteed closure-free and rollback-eligible)."""
    frames = _frames_out_and_back(rng)
    for j in (14, 15):  # return-path frames after the first return split
        p, d, ok = frames[j]
        frames[j] = (p, d, jnp.zeros_like(ok))
    ref = _drive_perframe(frames, loop=True)
    assert ref.num_relocalizations >= 1
    hit = 0
    for chunk in (16, 20):
        slam = _drive_chunked(frames, chunk, loop=True)
        _assert_equivalent(ref, slam)
        assert slam.num_losses == ref.num_losses
        hit += slam.num_reloc_rollbacks
    # at least one chunking must place the lost finish after the reloc
    # frame inside one chunk
    assert hit >= 1


def test_chunk_group_matches_ungrouped(rng):
    """chunk_group > 1 fuses G chunks into ONE dispatch (a lax.scan over
    whole chunks inside the chunk op) — must be bit-equivalent to the
    per-chunk dispatch cadence, including splits, losses, closures AND
    the relocalization replay (whose lo/hi live in group coordinates)."""
    frames = _frames_out_and_back(rng)
    ref = _drive_perframe(frames, loop=True)
    assert ref.num_relocalizations >= 1
    _assert_equivalent(ref, _drive_chunked(frames, 4, loop=True, group=2))
    _assert_equivalent(ref, _drive_chunked(frames, 4, loop=True, group=3))


def test_chunked_status_and_counters(rng):
    frames = _frames_linear(rng, n_frames=9)
    slam = _drive_chunked(frames, 4)
    assert slam.status == "Tracking"
    assert slam._frame_count == 9
    assert len(slam.timestamps()) == 9


def test_chunked_ring_eviction_matches_perframe(rng):
    """Ring-wrap eviction in CHUNKED mode: the device slot write evicts the
    oldest map and reports it in the packet (SM_EVICTED); the host mirror
    must track it exactly like the per-frame path does."""
    frames = _frames_linear(rng, n_frames=20, step_z=0.7)

    def cfg(chunk):
        return GraphSLAMConfig(
            splitting=SplittingConfig(maximum_translation_m=1.2),
            loop=LoopDetectorConfig(minimum_age_difference=1),
            arena_capacity=1024,
            database_capacity=1024,          # ring of 4 maps
            max_db_descriptors_per_map=256,
            enable_loop_closing=True,
            chunk_size=chunk,
        )

    ref = GraphSLAM(CAM, cfg(0))
    for i, (p, d, ok) in enumerate(frames):
        ref.process(p, d, ok, timestamp=0.1 * i)
    ref.flush()
    assert ref.num_db_evictions >= 1     # the scenario must wrap the ring

    slam = GraphSLAM(CAM, cfg(4))
    slam.process_meas_sequence(
        jnp.stack([f[0] for f in frames]),
        jnp.stack([f[1] for f in frames]),
        jnp.stack([f[2] for f in frames]),
        [0.1 * i for i in range(len(frames))])
    assert slam.num_db_evictions == ref.num_db_evictions
    assert sorted(slam._db_entries) == sorted(ref._db_entries)
    assert len(slam._db_entries) <= slam.db.num_slots
    _assert_equivalent(ref, slam)


def test_chunked_rgbd_image_path(rng):
    """The fused IMAGE chunk op drives the RGB-D model end to end on the
    bundled ICL frames (adaptor + tracker + status machine on device),
    matching the per-frame loop."""
    import os

    from srrg2_proslam_jax.io import datasets
    from srrg2_proslam_jax.models.frontend import (
        DepthAdaptorConfig, adapt_rgbd,
    )

    root = os.path.join(os.path.dirname(__file__), "..", "test_data")
    frames = list(datasets.iter_bundled_icl(root))
    assert len(frames) >= 3
    cam = datasets.icl_camera()
    acfg = DepthAdaptorConfig()

    def cfg(chunk):
        return GraphSLAMConfig(
            splitting=SplittingConfig(maximum_translation_m=5.0),
            arena_capacity=2048,
            enable_loop_closing=False,
            chunk_size=chunk,
        )

    ref = GraphSLAM(cam, cfg(0), model="rgbd")
    for i, fr in enumerate(frames):
        m = adapt_rgbd(jnp.asarray(fr.intensity), jnp.asarray(fr.depth),
                       acfg)
        ref.process(m.points, m.desc, m.valid, timestamp=0.1 * i)
    ref.flush()

    slam = GraphSLAM(cam, cfg(2), model="rgbd")
    slam.process_sequence(
        np.stack([fr.intensity for fr in frames]),
        np.stack([fr.depth for fr in frames]),
        [0.1 * i for i in range(len(frames))], acfg)
    _assert_equivalent(ref, slam)
