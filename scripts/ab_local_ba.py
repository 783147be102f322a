"""A/B: split-time local bundle adjustment on the rendered benchmark.

Round-2 verdict item (4): ``local_ba`` shipped dark.  This measures its
accuracy effect on the rendered closed-loop sequence (full pipeline,
per-frame mode) so the KITTI config can enable it with a cited number.

Run:  python scripts/ab_local_ba.py   (CPU fine)
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
    GraphSLAM, GraphSLAMConfig, LocalBAConfig, SplittingConfig,
)
from srrg2_proslam_jax.models.tracker import TrackerConfig


def run(local_ba: bool):
    config = GraphSLAMConfig(
        tracker=TrackerConfig(),
        splitting=SplittingConfig(maximum_translation_m=3.0,
                                  maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=3),
        local_ba=LocalBAConfig(enabled=local_ba),
        arena_capacity=4096,
        # 42 ring slots: the lap finishes ~25 maps and the loop MUST
        # still close against the first ones (a 21-slot ring evicted
        # maps 0-2 before the return leg -> 0 closures -> no signal)
        database_capacity=16384,
        max_db_descriptors_per_map=384,
    )
    cam = syn.synthetic_camera(rows=320, cols=416, fx=300.0)
    slam = GraphSLAM(cam, config, model="stereo")
    acfg = StereoAdaptorConfig()
    gt = []
    for fr in syn.iter_rendered_loop(side_a=8.0, side_b=6.0, step_m=0.4,
                                     turn_frames=8, rows=320, cols=416,
                                     fx=300.0):
        meas = adapt_stereo(jnp.asarray(fr.left), jnp.asarray(fr.right),
                            acfg)
        slam.process(meas.points, meas.desc, meas.valid, fr.timestamp)
        gt.append(fr.gt_pose)
    slam.flush()
    err = tm.evaluate(slam.trajectory(), gt)
    return err, slam


def main():
    enable_compile_cache()
    for enabled in (False, True):
        err, slam = run(enabled)
        rmse = np.asarray(err.mean_translation_rmse)
        print(f"local_ba={str(enabled):5s}: per-axis t-RMSE "
              f"{np.round(rmse, 4)} m, rot {err.mean_rotation_deg:.3f} deg, "
              f"ATE {err.ate_rmse:.4f} m "
              f"({slam.num_maps} maps, {slam.num_closures} closures, "
              f"{slam.num_backstop_rejections} backstop-rej)",
              flush=True)


if __name__ == "__main__":
    main()
