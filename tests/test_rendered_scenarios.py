"""Harder rendered scenarios on real images (VERDICT r2 item 5).

Three full-pipeline stress scenarios the plain closed loop cannot exercise,
all on RENDERED STEREO IMAGES through the complete frontend:

  * multi-lap circuit: every wall section is revisited on lap 2, so the
    detector must extract and accept MULTIPLE closures against MULTIPLE
    distinct old maps on real descriptors (the reference extracts
    correspondences per qualifying reference map,
    correspondence_finder_hbst.cpp:95-128);
  * exposure blow-out: a contrast-crushed stretch forces Lost on images,
    then the return leg must relocalize into a pre-blackout map
    (failure-recovery path, app_benchmark.cpp:150-178);
  * endurance with a tiny closure database: eviction fires on images and
    closures keep working afterwards (capacity lifecycle, §5.7).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from srrg2_proslam_jax.io import synthetic as syn
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



def _config(**kw):
    base = dict(
        tracker=TrackerConfig(),
        splitting=SplittingConfig(maximum_translation_m=3.0,
                                  maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=3),
        arena_capacity=4096,
        # ring slots = capacity // budget: 32 retained maps (the two-lap
        # and fast circuits produce ~26-30 maps; the revisited early maps
        # must still be resident when the loop closes)
        database_capacity=8192,
        max_db_descriptors_per_map=256,
    )
    base.update(kw)
    return GraphSLAMConfig(**base)


def _run(slam, frames):
    acfg = StereoAdaptorConfig()
    gt = []
    for fr in frames:
        meas = adapt_stereo(jnp.asarray(fr.left), jnp.asarray(fr.right),
                            acfg)
        slam.process(meas.points, meas.desc, meas.valid, fr.timestamp)
        gt.append(fr.gt_pose)
    slam.flush()
    return gt


@pytest.mark.slow
def test_two_lap_circuit_closes_to_multiple_maps():
    """Lap 2 must produce >= 3 accepted closures to >= 2 distinct old maps
    on real rendered descriptors (K > 1 candidate extraction on images)."""
    slam = GraphSLAM(syn.synthetic_camera(rows=320, cols=416, fx=300.0),
                     _config(), model="stereo")
    frames = syn.iter_rendered_loop(side_a=8.0, side_b=6.0, step_m=0.4,
                                    turn_frames=8, laps=2,
                                    rows=320, cols=416, fx=300.0)
    _run(slam, frames)
    assert slam.num_closures >= 3, slam.num_closures
    refs = {ref for ref, _query in slam.closure_events}
    assert len(refs) >= 2, slam.closure_events
    assert slam.num_relocalizations >= 1


@pytest.mark.slow
def test_exposure_blowout_lost_then_relocalize():
    """A contrast-crushed stretch on the return leg forces Lost on images;
    tracking recovers into a fresh map and the start-region overlap then
    relocalizes into a pre-blackout map."""
    cam = syn.synthetic_camera(rows=320, cols=416, fx=300.0)
    planes = syn.make_room(size_x=18.0, size_z=26.0)
    poses = syn.out_and_back_trajectory(length_m=12.0, step_m=0.4,
                                        turn_frames=10, overlap_frames=10)
    n = len(poses)
    blackout = range(n // 2 + 6, n // 2 + 10)
    slam = GraphSLAM(cam, _config(), model="stereo")
    acfg = StereoAdaptorConfig()
    for i, T_wc in enumerate(poses):
        left, right, _ = syn.render_stereo(cam, jnp.asarray(T_wc), planes)
        if i in blackout:
            left = syn.crush_exposure(left)
            right = syn.crush_exposure(right)
        meas = adapt_stereo(left, right, acfg)
        slam.process(meas.points, meas.desc, meas.valid, 0.1 * i)
    slam.flush()
    assert slam.num_losses >= 1, "blackout must lose tracking"
    assert slam.num_relocalizations >= 1, "return leg must relocalize"


@pytest.mark.slow
def test_endurance_eviction_on_images():
    """1000+ frames with a database that holds only ~4 maps: evictions
    MUST fire on images, and closures still happen afterwards against the
    surviving recent maps."""
    cam = syn.synthetic_camera(rows=320, cols=416, fx=300.0)
    config = _config(
        # retains ~32 maps (one lap is ~25: translation splits on the
        # straights + rotation splits in the turns): old laps evict, yet
        # the previous lap's maps survive long enough to close against
        database_capacity=6144,
        max_db_descriptors_per_map=192,
        arena_capacity=2048,
    )
    slam = GraphSLAM(cam, config, model="stereo")
    frames = syn.iter_rendered_loop(side_a=8.0, side_b=6.0, step_m=0.4,
                                    turn_frames=8, laps=11,
                                    rows=320, cols=416, fx=300.0)
    n = 0
    acfg = StereoAdaptorConfig()
    for fr in frames:
        meas = adapt_stereo(jnp.asarray(fr.left), jnp.asarray(fr.right),
                            acfg)
        slam.process(meas.points, meas.desc, meas.valid, fr.timestamp)
        n += 1
    slam.flush()
    assert n >= 1000
    assert slam.num_db_evictions >= 1
    assert slam.num_closures >= 1
    # the db never overflows: total mirror rows fit the capacity
    total = sum(slam._entry_count(e, exact=True)
                for e in slam._db_entries.values())
    assert total <= config.database_capacity


@pytest.mark.slow
def test_fast_rotation_under_kitti_gates():
    """Harder variant (VERDICT r3 item 9): the e2e circuit driven FASTER
    (0.45 m/frame vs 0.4) with SHARPER turns (11.25 deg/frame vs 9), with
    the SSD sub-pixel refinement ON — the aggressive-motion regime is
    exactly where that dial earns its keep (closure recall at 11 deg/frame
    turns is lost without it; the gentle-motion defaults retire it, and
    the EuRoC MAV adaptor config ships it on).  The
    run must still pass the reference KITTI CI gates
    (benchmark_kitti.cpp:18-21) and close the loop.  Probed harder
    settings documented as limits AT THE DEFAULT ESTIMATOR: 15 deg/frame
    turns do not close, 0.45-0.5 m/frame and 14x8/12x7 m circuits exceed
    the 0.30 m gate.  Round 5 A/B'd the estimator arsenal on those
    regimes (scripts/ab_motion_envelopes.py, RESULTS.md): the pose-based
    smoother restores closure recall at 15 deg/frame (0 -> 4 closures,
    error 1.32 -> 0.31 m) and with inverse-depth weighting brings the
    other two within 3-8% of the gate — shipped as
    configurations/aggressive_motion_*.json."""
    from srrg2_proslam_jax.metrics import trajectory as tm

    cam = syn.synthetic_camera(rows=320, cols=416, fx=300.0)
    planes = syn.make_room(size_x=20.0, size_z=26.0)
    poses = syn.loop_trajectory(side_a=10.0, side_b=6.0, step_m=0.45,
                                turn_frames=8)
    slam = GraphSLAM(cam, _config(), model="stereo")
    acfg = StereoAdaptorConfig(subpixel_refinement=True)
    gt = []
    for i, T_wc in enumerate(poses):
        left, right, _ = syn.render_stereo(cam, jnp.asarray(T_wc), planes)
        meas = adapt_stereo(left, right, acfg)
        slam.process(meas.points, meas.desc, meas.valid, 0.1 * i)
        gt.append(np.linalg.inv(np.asarray(T_wc)).astype(np.float32))
    slam.flush()
    assert len(gt) >= 80
    assert slam.num_maps >= 8
    assert slam.num_closures >= 1
    err = tm.evaluate(slam.trajectory(), gt)
    rmse = np.asarray(err.mean_translation_rmse)
    assert np.all(rmse <= 0.30), rmse
    assert err.mean_rotation_deg <= 3.0, err.mean_rotation_deg


@pytest.mark.slow
def test_aliased_texture_no_false_closures():
    """Texture-aliasing PRECISION at DEFAULT gates: with the room texture
    repeating every ~5 m (tex_size=128 at 24 px/m wraps), whole wall
    sections look IDENTICAL — the reference's Lowe + chi gates
    (kitti.conf:970-977) accept a geometrically self-consistent but WRONG
    closure here (measured round 4: maps (32, 44) paired across repeats;
    perceptual aliasing defeats appearance gating categorically).  The
    round-5 defense BEATS the reference instead of merely matching it:
    the geometric backstop (LoopDetectorConfig.backstop_max_edge_residual)
    re-checks the pre-existing factors' residuals after the speculative
    PGO and rejects closures that bend the chain against its own odometry
    — so the DEFAULT minimum_matches now hold precision (VERDICT r4
    item 3; round 4 shipped gate-tightening to 100 instead)."""
    from srrg2_proslam_jax.metrics import trajectory as tm

    cam = syn.synthetic_camera(rows=320, cols=416, fx=300.0)
    planes = syn.make_room(size_x=20.0, size_z=26.0, tex_size=128)
    poses = syn.loop_trajectory(side_a=12.0, side_b=7.0, step_m=0.45,
                                turn_frames=8)
    config = _config(loop=LoopDetectorConfig(minimum_age_difference=3))
    slam = GraphSLAM(cam, config, model="stereo")
    first_frame = {}
    acfg = StereoAdaptorConfig()
    gt = []
    for i, T_wc in enumerate(poses):
        left, right, _ = syn.render_stereo(cam, jnp.asarray(T_wc), planes)
        meas = adapt_stereo(left, right, acfg)
        slam.process(meas.points, meas.desc, meas.valid, 0.1 * i)
        first_frame.setdefault(slam.current_map, i)
        gt.append(np.linalg.inv(np.asarray(T_wc)).astype(np.float32))
    slam.flush()
    assert slam.num_maps >= 8
    # the aliased candidates DO pass the reference gates — the backstop
    # must be what rejects them (otherwise this run proves nothing)
    assert slam.num_backstop_rejections >= 1, \
        "expected the geometric backstop to fire on an aliased candidate"
    # PRECISION: every closure that survives must be geometrically TRUE —
    # the linked maps' GT positions close together (the end-of-loop
    # revisit is a legitimate closure; what must never pass is a pairing
    # of distant look-alike walls)
    for ref, query in slam.closure_events:
        pa = gt[first_frame[ref]][:3, 3]
        pb = gt[min(first_frame.get(query, len(gt) - 1), len(gt) - 1)][:3, 3]
        d = np.linalg.norm(pa - pb)
        assert d < 6.0, ("FALSE closure between maps "
                         f"{ref} and {query}: {d:.1f} m apart")
