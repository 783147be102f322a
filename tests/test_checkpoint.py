"""Checkpoint/resume: a restored session must continue bit-identically."""
import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.io import checkpoint
from srrg2_proslam_jax.io.datasets import kitti_camera
from srrg2_proslam_jax.models.slam import GraphSLAM, GraphSLAMConfig, SplittingConfig
from tests.test_slam import CAM, _world, _stereo_measurements


def _run(slam, pts_w, desc, zs):
    import srrg2_proslam_jax.ops.se3 as se3
    for i, z in enumerate(zs):
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[2, 3] = -z
        p, d, ok = _stereo_measurements(pts_w, desc, T_wc)
        slam.process(p, d, ok, timestamp=0.1 * i)
    return slam


def test_checkpoint_roundtrip_continues_identically(rng, tmp_path):
    pts_w = _world(rng)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(pts_w.shape[0], 256))
    config = GraphSLAMConfig(
        splitting=SplittingConfig(maximum_translation_m=1.0),
        arena_capacity=1024, enable_loop_closing=True,
        database_capacity=8192,
    )

    # run A: frames 0..7, checkpoint, continue 8..11
    zs = list(np.arange(0, 3.0, 0.25))
    a = GraphSLAM(CAM, config)
    _run(a, pts_w, desc, zs[:8])
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(a, path)
    _run(a, pts_w, desc, zs[8:])

    # run B: restore at frame 8, continue with the same input
    b = GraphSLAM(CAM, config)
    checkpoint.load(b, path)
    assert b.num_maps == a.num_maps or b.num_maps <= a.num_maps
    assert b._frame_count == 8
    _run(b, pts_w, desc, zs[8:])

    # identical continuation: same maps, same trajectory
    assert b.num_maps == a.num_maps
    assert b.num_edges == a.num_edges
    ta, tb = a.trajectory(), b.trajectory()
    assert len(tb) == len(zs)  # restored session re-records frames 8..11
    np.testing.assert_allclose(tb[-1], ta[-1], atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(a.robot_in_world()), np.asarray(b.robot_in_world())
    )
