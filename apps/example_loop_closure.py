"""Didactic example: the loop-closure subsystem in isolation.

Parity with the reference's didactic loop-closure demonstration
(test_loop_closing.cpp's mock-graph walkthrough): build a descriptor
database from two synthetic local maps, query a revisit of map 0 under a
known SE3 offset, and print the vote histogram, the per-candidate
validation (inliers / chi / ratio vs the acceptance gates,
kitti.conf:970-977), and the recovered transform against ground truth.

Usage: python apps/example_loop_closure.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.models import loop_closure
from srrg2_proslam_jax.ops import se3


def main():
    rng = np.random.RandomState(0)
    cfg = loop_closure.LoopDetectorConfig(minimum_age_difference=1)
    db = loop_closure.empty_database(4096)

    # two old local maps with random 256-bit descriptors
    pts0 = rng.uniform(-5, 5, (200, 3)).astype(np.float32) + [0, 0, 10]
    desc0 = rng.choice(np.array([-1, 1], np.int8), size=(200, 256))
    db = loop_closure.add_local_map(
        db, jnp.asarray(desc0), jnp.asarray(pts0), jnp.ones(200, bool), 0)
    desc1 = rng.choice(np.array([-1, 1], np.int8), size=(150, 256))
    db = loop_closure.add_local_map(
        db, jnp.asarray(desc1),
        jnp.asarray(rng.uniform(-5, 5, (150, 3)).astype(np.float32)),
        jnp.ones(150, bool), 1)
    print(f"database: {int(np.asarray(jnp.sum(db.valid)))} descriptors from 2 maps")

    # the query map re-observes map 0's landmarks, displaced by a known SE3
    # and with 5 descriptor bits flipped (sensor noise)
    T_gt = np.asarray(se3.exp(jnp.asarray(
        np.array([0.5, -0.2, 1.0, 0.02, -0.01, 0.05], np.float32))))
    q_desc = desc0.copy()
    for i in range(200):
        idx = rng.choice(256, size=5, replace=False)
        q_desc[i, idx] = -q_desc[i, idx]
    q_pts = pts0 @ np.linalg.inv(T_gt)[:3, :3].T + np.linalg.inv(T_gt)[:3, 3]

    result = loop_closure.query(
        jnp.asarray(q_desc), jnp.ones(200, bool), 5, db, cfg, num_maps=8)
    print("candidate maps:", np.asarray(result.candidate_maps))
    print("votes:         ", np.asarray(result.votes))

    poses = jnp.broadcast_to(jnp.eye(4), (8, 4, 4))
    T_init = jnp.broadcast_to(jnp.eye(4), (result.candidate_maps.shape[0],
                                           4, 4))
    closures = loop_closure.validate_batch(
        jnp.asarray(q_pts.astype(np.float32)), result, T_init, cfg)
    for k in range(int(result.candidate_maps.shape[0])):
        cand = int(result.candidate_maps[k])
        if cand < 0:
            continue
        print(f"candidate map {cand}: inliers="
              f"{int(closures.num_inliers[k])} "
              f"chi/inl={float(closures.chi_per_inlier[k]):.3f} "
              f"ratio={float(closures.inlier_ratio[k]):.2f} "
              f"accepted={bool(closures.accepted[k])} "
              f"(gates: >={cfg.relocalize_min_inliers} inl, "
              f"<={cfg.relocalize_max_chi_inliers} chi, "
              f">={cfg.relocalize_min_inliers_ratio} ratio)")
        if bool(closures.accepted[k]):
            T_est = np.asarray(closures.T_query_in_ref[k])
            err = np.asarray(se3.log(jnp.asarray(
                np.linalg.inv(T_est) @ T_gt)))
            print(f"  recovered T error: |t|={np.linalg.norm(err[:3]):.4f} m"
                  f" |r|={np.linalg.norm(err[3:]):.5f} rad")


if __name__ == "__main__":
    main()
