"""Device-mesh parallelism for the SLAM pipeline (new design, not ported).

The reference is strictly single-threaded (SURVEY.md §2.3 — its only thread
is the Qt viewer), so every sharding here is original design:
measurements sharded across devices for matching/alignment, landmark arenas
sharded for the vmapped filter updates, the loop-closure descriptor database
sharded for place recognition at scale, and pose-graph factors sharded for
the global optimization — with XLA inserting the psum/all-gather collectives
from sharding annotations (the scaling-book recipe: pick a mesh, annotate,
let GSPMD do the rest).
"""
from .spmd import (  # noqa: F401
    make_mesh,
    shard_frame_inputs,
    slam_step_spmd,
    pgo_optimize_spmd,
    loop_query_spmd,
    ba_optimize_spmd,
)
from . import multihost  # noqa: F401
