"""A/B the estimator arsenal on the documented motion-envelope failures.

Round-4 verdict item 6: three regimes fail at the shipped defaults —
15 deg/frame turns do not close, 0.5 m/frame steps and 14x8 m circuits
exceed the 0.30 m KITTI gate.  The reference's estimator families exist to
cut exactly this drift (pose-based smoother M8,
landmark_estimator_pose_based_smoother_impl.cpp:55-133; mean-disparity
inverse-depth weighting, aligner_slice_processor_projective.cpp:107-112),
and both are implemented but default-off.  This script measures every
combination on every failing regime so per-regime config guidance in
RESULTS.md cites numbers.

Run:  python scripts/ab_motion_envelopes.py           (CPU fine, ~30 min)
      python scripts/ab_motion_envelopes.py --fast    (first scenario only)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from srrg2_proslam_jax.utils.compile_cache import enable_compile_cache
from srrg2_proslam_jax.io import synthetic as syn
from srrg2_proslam_jax.metrics import trajectory as tm
from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig, adapt_stereo
from srrg2_proslam_jax.models.loop_closure import LoopDetectorConfig
from srrg2_proslam_jax.models.slam import (
    GraphSLAM, GraphSLAMConfig, SplittingConfig,
)
from srrg2_proslam_jax.models.tracker import TrackerConfig

SCENARIOS = {
    # 15 deg/frame turns (turn_frames=6): closure recall failure
    "turn15deg": dict(side_a=10.0, side_b=6.0, step_m=0.45, turn_frames=6),
    # 0.5 m/frame forward speed: forward-axis RMSE past the 0.30 m gate
    "step0.5m": dict(side_a=10.0, side_b=6.0, step_m=0.5, turn_frames=8),
    # 14x8 m circuit: accumulated drift past the gate
    "circuit14x8": dict(side_a=14.0, side_b=8.0, step_m=0.45,
                        turn_frames=8),
}

VARIANTS = {
    "baseline": dict(),
    "idw": dict(stereo_inverse_depth_weighting=True),
    "smoother": dict(landmark_estimator="smoother"),
    "idw+smoother": dict(stereo_inverse_depth_weighting=True,
                         landmark_estimator="smoother"),
}


def run(scn: dict, tweaks: dict):
    cam = syn.synthetic_camera(rows=320, cols=416, fx=300.0)
    planes = syn.make_room(size_x=max(20.0, scn["side_a"] + 6.0),
                           size_z=max(26.0, scn["side_b"] + 18.0))
    poses = syn.loop_trajectory(**scn)
    config = GraphSLAMConfig(
        tracker=TrackerConfig(**tweaks),
        splitting=SplittingConfig(maximum_translation_m=3.0,
                                  maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=3),
        arena_capacity=4096,
        database_capacity=8192,
        max_db_descriptors_per_map=256,
    )
    slam = GraphSLAM(cam, config, model="stereo")
    # the aggressive-motion regime runs the sub-pixel dial ON (the
    # fast-rotation scenario's shipped posture)
    acfg = StereoAdaptorConfig(subpixel_refinement=True)
    gt = []
    for i, T_wc in enumerate(poses):
        left, right, _ = syn.render_stereo(cam, jnp.asarray(T_wc), planes)
        meas = adapt_stereo(left, right, acfg)
        slam.process(meas.points, meas.desc, meas.valid, 0.1 * i)
        gt.append(np.linalg.inv(np.asarray(T_wc)).astype(np.float32))
    slam.flush()
    err = tm.evaluate(slam.trajectory(), gt)
    return err, slam


def main():
    enable_compile_cache()
    fast = "--fast" in sys.argv
    for sname, scn in SCENARIOS.items():
        for vname, tweaks in VARIANTS.items():
            err, slam = run(scn, tweaks)
            rmse = np.asarray(err.mean_translation_rmse)
            ok = (np.all(rmse <= 0.30) and err.mean_rotation_deg <= 3.0
                  and slam.num_closures >= 1)
            print(f"{sname:12s} {vname:13s}: t-RMSE {np.round(rmse, 3)} m "
                  f"rot {err.mean_rotation_deg:5.2f} deg  "
                  f"closures {slam.num_closures} relocs "
                  f"{slam.num_relocalizations} rej "
                  f"{slam.num_backstop_rejections} -> "
                  f"{'PASS' if ok else 'fail'}", flush=True)
        if fast:
            break


if __name__ == "__main__":
    main()
