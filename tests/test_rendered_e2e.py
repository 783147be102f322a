"""Rendered-image end-to-end SLAM regression (VERDICT r1 item 1).

Drives the FULL pipeline — FAST/BRIEF frontend, epipolar stereo matching,
tracker, local-map splits, loop closure, relocalization, PGO — over a
rendered closed-loop stereo sequence of real IMAGES (io/synthetic.py)
against exact ground truth, asserting the reference's KITTI-style per-axis
RMSE gates (reference srrg2_proslam/benchmarks/benchmark_kitti.cpp:18-21:
mean translation RMSE <= 0.30 m per axis, mean rotation RMSE <= 3 deg) with
at least one loop closure fired on real descriptors.

This is the image-validated analog of the reference's full-dataset
regression benchmarks (A3) — no dataset can be mounted in this environment,
so the sequence is synthesized by the jitted renderer.  A longer variant
(253 frames, 20x10 m circuit) runs via scripts/rendered_e2e.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from srrg2_proslam_jax.io import synthetic as syn
from srrg2_proslam_jax.metrics import trajectory as tm
from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig, adapt_stereo
from srrg2_proslam_jax.models.loop_closure import LoopDetectorConfig
from srrg2_proslam_jax.models.slam import (
    GraphSLAM, GraphSLAMConfig, SplittingConfig,
)
from srrg2_proslam_jax.models.tracker import TrackerConfig


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



@pytest.mark.slow
def test_rendered_closed_loop_passes_kitti_gates():
    config = GraphSLAMConfig(
        tracker=TrackerConfig(),
        splitting=SplittingConfig(maximum_translation_m=4.0,
                                  maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=3),
        arena_capacity=4096,
        database_capacity=8192,
        max_db_descriptors_per_map=384,
    )
    cam = syn.synthetic_camera()
    slam = GraphSLAM(cam, config, model="stereo")
    acfg = StereoAdaptorConfig()

    gt = []
    for fr in syn.iter_rendered_loop(side_a=10.0, side_b=6.0, step_m=0.4,
                                     turn_frames=10):
        meas = adapt_stereo(jnp.asarray(fr.left), jnp.asarray(fr.right), acfg)
        slam.process(meas.points, meas.desc, meas.valid, fr.timestamp)
        gt.append(fr.gt_pose)

    assert len(gt) > 120
    assert slam.num_maps >= 10          # splits actually happened
    assert slam.num_closures >= 1       # closure on real descriptors
    assert slam.num_relocalizations >= 1

    err = tm.evaluate(slam.trajectory(), gt)
    rmse = np.asarray(err.mean_translation_rmse)
    # reference CI gates, benchmark_kitti.cpp:18-21
    assert np.all(rmse <= 0.30), rmse
    assert err.mean_rotation_deg <= 3.0, err.mean_rotation_deg
    # drift must stay bounded absolutely too (closure pulled the loop shut)
    assert err.ate_rmse <= 0.5, err.ate_rmse
