"""Dissect the turn-onset alignment failure: run the tracker to frame 57,
cache the state, then sweep matcher schedules on frame 58 with GT
supervision.  Usage: --rebuild to refresh the cached state."""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from srrg2_proslam_jax.io import synthetic as syn
from srrg2_proslam_jax.models.frontend import StereoAdaptorConfig, adapt_stereo
from srrg2_proslam_jax.models.slam import GraphSLAM, GraphSLAMConfig, SplittingConfig
from srrg2_proslam_jax.models.loop_closure import LoopDetectorConfig
from srrg2_proslam_jax.models.tracker import TrackerConfig
from srrg2_proslam_jax.ops import se3
from srrg2_proslam_jax.ops.pinhole import project
from srrg2_proslam_jax.ops.matching import ProjectiveMatcherConfig, match_projective
from srrg2_proslam_jax.ops.gn import stereo_projective_system, gn_step

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     ".diag_cache", "diag_turn_state.npz")


def rebuild():
    config = GraphSLAMConfig(
        tracker=TrackerConfig(),
        splitting=SplittingConfig(maximum_translation_m=5.0,
                                  maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=5),
        arena_capacity=4096, database_capacity=16384,
        max_db_descriptors_per_map=512,
    )
    cam = syn.synthetic_camera()
    slam = GraphSLAM(cam, config, model="stereo")
    acfg = StereoAdaptorConfig()
    frames = []
    for n, fr in enumerate(syn.iter_rendered_loop(count=59)):
        frames.append(fr)
        if n == 58:
            break
        meas = adapt_stereo(jnp.asarray(fr.left), jnp.asarray(fr.right), acfg)
        slam.process(meas.points, meas.desc, meas.valid, fr.timestamp)

    fr = frames[58]
    state = slam.tracker_state
    meas = adapt_stereo(jnp.asarray(fr.left), jnp.asarray(fr.right), acfg)
    T_c57 = np.linalg.inv(frames[57].gt_pose)
    T_c58 = np.linalg.inv(frames[58].gt_pose)
    delta_gt = T_c58 @ np.linalg.inv(T_c57)
    X_57 = np.asarray(se3.inverse(state.T_lm_robot))
    X_gt = delta_gt @ X_57
    T_pred = np.asarray(state.T_lm_robot) @ np.asarray(se3.exp(state.velocity))
    os.makedirs(os.path.dirname(CACHE), exist_ok=True)
    np.savez(CACHE,
             arena_pos=np.asarray(state.arena.pos),
             arena_desc=np.asarray(state.arena.desc),
             arena_valid=np.asarray(state.arena.valid),
             arena_nup=np.asarray(state.arena.num_updates),
             meas_points=np.asarray(meas.points),
             meas_desc=np.asarray(meas.desc),
             meas_valid=np.asarray(meas.valid),
             X_pred=np.linalg.inv(T_pred), X_gt=X_gt,
             velocity=np.asarray(state.velocity))
    print("cached state to", CACHE)


def sweep():
    cam = syn.synthetic_camera()
    d = np.load(CACHE)
    pos = jnp.asarray(d["arena_pos"])
    desc = jnp.asarray(d["arena_desc"])
    valid = jnp.asarray(d["arena_valid"])
    weights_all = 1.0 + jnp.log1p(jnp.asarray(d["arena_nup"]).astype(jnp.float32))
    meas_uv = jnp.asarray(d["meas_points"][:, :2])
    gn_meas = jnp.asarray(d["meas_points"][:, :3])
    mdesc = jnp.asarray(d["meas_desc"])
    mvalid = jnp.asarray(d["meas_valid"])
    X_pred = jnp.asarray(d["X_pred"], jnp.float32)
    X_gt = jnp.asarray(d["X_gt"], jnp.float32)
    print("pred-gt twist:", np.asarray(se3.log(
        X_gt @ se3.inverse(X_pred))).round(4))

    configs = {
        "baseline r(10,25,50) d(25,50,75)": ProjectiveMatcherConfig(),
        "flipped  r(10,25,50) d(75,50,25)": ProjectiveMatcherConfig(
            descriptor_stages=(75.0, 50.0, 25.0)),
        "wide-flip r(10,25,90) d(75,50,25)": ProjectiveMatcherConfig(
            radius_stages=(10.0, 25.0, 90.0),
            descriptor_stages=(75.0, 50.0, 25.0)),
        "wide-strict r(10,30,90) d(50,35,20)": ProjectiveMatcherConfig(
            radius_stages=(10.0, 30.0, 90.0),
            descriptor_stages=(50.0, 35.0, 20.0)),
        "wide-vstrict r(10,30,90) d(40,25,15)": ProjectiveMatcherConfig(
            radius_stages=(10.0, 30.0, 90.0),
            descriptor_stages=(40.0, 25.0, 15.0)),
    }
    for name, mcfg in configs.items():
        X = X_pred
        n_stages = len(mcfg.radius_stages)
        print(f"\n== {name}")
        for r in range(3):
            pts_sensor = se3.transform_points(X, pos)
            proj_uv, in_view = project(cam, pts_sensor)
            proj_valid = valid & in_view
            matches, stage = match_projective(
                meas_uv, mdesc, mvalid, proj_uv, desc, proj_valid, mcfg,
                force_stage=-1 if r == 2 else max(n_stages - 1 - r, 0))
            pts_gtp = se3.transform_points(X_gt, pos)
            uv_gt, _ = project(cam, pts_gtp)
            idx = np.maximum(np.asarray(matches.idx), 0)
            mk = np.asarray(matches.mask)
            err_px = np.linalg.norm(
                np.asarray(meas_uv) - np.asarray(uv_gt)[idx], axis=1)
            good = mk & (err_px < 3.0)
            idxj = jnp.maximum(matches.idx, 0)
            pm = pos[idxj]
            w = weights_all[idxj]
            for it in range(5):
                H, b, stats = stereo_projective_system(
                    X, pm, gn_meas, w, matches.mask, cam, 25.0)
                X = gn_step(X, H, b, 1e-6)
            tw = np.asarray(se3.log(X_gt @ se3.inverse(X)))
            print(f" round{r} stage={int(stage)} m={mk.sum():4d} "
                  f"correct={good.sum():4d} ({good.sum()/max(mk.sum(),1):.2f}) "
                  f"-> inl={int(stats.num_inliers):4d} "
                  f"t_err={np.linalg.norm(tw[:3]):.4f} "
                  f"r_err={np.linalg.norm(tw[3:]):.4f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rebuild", action="store_true")
    args = ap.parse_args()
    if args.rebuild or not os.path.exists(CACHE):
        rebuild()
    sweep()
