"""Relocalization: returning to a mapped area must reload the old local map."""
import numpy as np

from srrg2_proslam_jax.models.loop_closure import LoopDetectorConfig
from srrg2_proslam_jax.models.slam import (
    GraphSLAM, GraphSLAMConfig, SplittingConfig,
)
from tests.test_slam import CAM, _world, _stereo_measurements


def test_out_and_back_relocalizes(rng):
    pts_w = _world(rng, n=500)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(500, 256))
    config = GraphSLAMConfig(
        splitting=SplittingConfig(maximum_translation_m=0.5),
        loop=LoopDetectorConfig(minimum_age_difference=3, minimum_matches=25),
        arena_capacity=1024,
        database_capacity=16384,
        enable_loop_closing=True,
    )
    slam = GraphSLAM(CAM, config)
    # out 3.5 m and back to the start: the final splits see the first maps'
    # viewpoints again, far enough in map-age to pass the gate
    zs = list(np.arange(0, 3.5, 0.25)) + list(np.arange(3.5, -0.01, -0.25))
    for i, z in enumerate(zs):
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[2, 3] = -z
        p, d, ok = _stereo_measurements(pts_w, desc, T_wc)
        slam.process(p, d, ok, timestamp=0.1 * i)

    assert slam.num_closures >= 1, (
        slam.num_maps, slam.num_closures, slam.num_relocalizations
    )
    assert slam.num_relocalizations >= 1
    # trajectory closes: final position back at the origin
    traj = slam.trajectory()
    final_err = np.linalg.norm(traj[-1][:3, 3])
    assert final_err < 0.3, final_err
