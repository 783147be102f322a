"""Mesh-integrated orchestrator equivalence (VERDICT r3 item 3).

``GraphSLAM(mesh=...)`` shards the closure ring (budget axis) and the
pose-graph factor arrays (edge axis) over the device mesh, so the
production stages — the fused chunk op, the split-time loop query +
validation + PGO, relocalization — run SPMD with compiler-inserted
collectives.  These tests pin end-to-end equivalence of the sharded full
SLAM run against the single-device run on the 8-virtual-device CPU mesh,
in both the per-frame and the chunked (production) execution modes.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from srrg2_proslam_jax import parallel
from srrg2_proslam_jax.models.loop_closure import LoopDetectorConfig
from srrg2_proslam_jax.models.slam import (
    GraphSLAM, GraphSLAMConfig, SplittingConfig,
)
from tests.test_slam import CAM
from tests.test_speculation import _frames_out_and_back


@pytest.fixture(autouse=True, scope="module")
def _fresh_jit_caches():
    """Bound the live-executable count (XLA:CPU segfault mitigation)."""
    jax.clear_caches()
    yield


def _config(chunk=0):
    # shapes stay small: the SPMD partitioner's compile time on the
    # virtual CPU mesh grows steeply with the fused chunk op's array sizes
    return GraphSLAMConfig(
        splitting=SplittingConfig(maximum_translation_m=1.2),
        loop=LoopDetectorConfig(minimum_age_difference=1),
        arena_capacity=512,
        database_capacity=2048,
        max_db_descriptors_per_map=256,
        max_local_maps=64,
        max_edges=256,
        enable_loop_closing=True,
        chunk_size=chunk,
    )


def _drive(slam, frames, chunk):
    if chunk:
        slam.process_meas_sequence(
            jnp.stack([f[0] for f in frames]),
            jnp.stack([f[1] for f in frames]),
            jnp.stack([f[2] for f in frames]),
            [0.1 * i for i in range(len(frames))])
    else:
        for i, (p, d, ok) in enumerate(frames):
            slam.process(p, d, ok, timestamp=0.1 * i)
        slam.flush()
    return slam


@pytest.mark.parametrize("chunk", [0, 4])
def test_meshed_full_slam_matches_single_device(rng, chunk):
    frames = _frames_out_and_back(rng)
    ref = _drive(GraphSLAM(CAM, _config(chunk)), frames, chunk)
    assert ref.num_closures >= 1       # the run must exercise the query
    mesh = parallel.make_mesh(jax.devices()[:8])
    got = _drive(GraphSLAM(CAM, _config(chunk), mesh=mesh), frames, chunk)
    assert got.num_maps == ref.num_maps
    assert got.num_closures == ref.num_closures
    assert got.num_relocalizations == ref.num_relocalizations
    np.testing.assert_allclose(
        np.stack(got.trajectory()), np.stack(ref.trajectory()), atol=1e-4)


def test_mesh_divisibility_is_validated():
    import dataclasses

    mesh = parallel.make_mesh(jax.devices()[:8])
    bad = dataclasses.replace(_config(),
                              max_db_descriptors_per_map=68)  # 68 % 8 != 0
    with pytest.raises(ValueError, match="divisible"):
        GraphSLAM(CAM, bad, mesh=mesh)
