"""SPMD sharding of the SLAM stages over a jax.sharding.Mesh.

Sharding layout (1-D mesh axis ``"d"`` in round 1; the axes generalize to a
2-D (map, feat) mesh for multi-host):

  * frame step (``slam_step_spmd``): measurement rows sharded over ``d``
    (the SLAM analog of sequence parallelism — each device owns a slice of
    the frame's keypoints), landmark arena sharded over ``d`` for the
    EKF/merge phase (tensor-parallel analog over the map).  The Hamming
    cost matrix [N, M] is computed as sharded-N x gathered-M int8 matmul;
    XLA inserts the all-gather for the column-side mutual-argmin reduction
    and the psum for the Gauss-Newton (H, b) 6x6 system automatically from
    the sharding annotations.
  * loop query (``loop_query_spmd``): the slotted descriptor ring sharded
    over ``d`` along its budget axis — each device matches the query
    against its stripe of every map; the per-slot two-best and vote
    reductions are cross-shard min/psum.
  * PGO (``pgo_optimize_spmd``): factor arrays sharded over ``d``; each
    device reduces its factors' contributions to the dense normal
    equations, combined by psum; the small 6Nx6N solve is replicated.

The reference has no parallel execution at all (SURVEY.md §2.3); these are
new designs whose *math* matches the single-device kernels bit-for-shape.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import loop_closure
from ..models.tracker import TrackerConfig, TrackerState, track_step
from ..ops import pgo as pgo_ops
from ..ops.pinhole import Camera
from ..utils import config as cfg


def make_mesh(devices=None, axis: str = "d") -> Mesh:
    import numpy as np

    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def _pad_to_multiple(n: int, k: int) -> int:
    return -(-n // k) * k


def shard_frame_inputs(mesh: Mesh, state: TrackerState, points, desc, valid,
                       axis: str = "d"):
    """Place frame inputs with their SPMD layout on the mesh.

    Measurement arrays shard along the keypoint axis; the tracker state's
    arena shards along the landmark axis (pos/cov/desc/num_updates/valid);
    poses/velocity replicate.  Capacities must divide the mesh size —
    fixed-capacity arrays make this a static property of the config.
    """
    row = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    points = jax.device_put(points, row)
    desc = jax.device_put(desc, row)
    valid = jax.device_put(valid, row)
    arena = state.arena
    arena = arena._replace(
        pos=jax.device_put(arena.pos, row),
        cov=jax.device_put(arena.cov, row),
        desc=jax.device_put(arena.desc, row),
        num_updates=jax.device_put(arena.num_updates, row),
        valid=jax.device_put(arena.valid, row),
    )
    meas_buf = state.meas_buf
    if meas_buf is not None:
        # smoother ring buffers shard along the landmark axis like the arena
        meas_buf = jax.tree_util.tree_map(
            lambda a: jax.device_put(a, row), meas_buf
        )
    state = TrackerState(
        arena=arena,
        T_lm_robot=jax.device_put(state.T_lm_robot, rep),
        velocity=jax.device_put(state.velocity, rep),
        meas_buf=meas_buf,
    )
    return state, points, desc, valid


@partial(jax.jit, static_argnames=("config", "cam", "model"))
def _step(state, points, desc, valid, cam, config, model):
    return track_step(state, points, desc, valid, cam, config, model)


def slam_step_spmd(mesh: Mesh, state: TrackerState, points, desc, valid,
                   cam: Camera, config: TrackerConfig, model: str = "stereo"):
    """One sharded tracker step: same jitted program, GSPMD-partitioned.

    The single-device ``track_step`` is already expressed as fixed-shape
    batched linear algebra, so partitioning is purely a placement decision:
    sharded inputs in, XLA propagates the layout through the cost matmuls,
    reductions, and scatters, inserting collectives where the mutual-argmin
    and (H, b) reductions cross shards.
    """
    state, points, desc, valid = shard_frame_inputs(mesh, state, points, desc, valid)
    # the fused GN kernel is a one-device program: keep the XLA path here,
    # as GraphSLAM(mesh=...) does
    config = cfg.replace(config, gn_pallas=False)
    return _step(state, points, desc, valid, cam, config, model)


def pgo_optimize_spmd(mesh: Mesh, graph: pgo_ops.PoseGraph,
                      config: pgo_ops.PGOConfig, axis: str = "d"):
    """Factor-sharded pose-graph optimization."""
    row = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    graph = graph._replace(
        poses=jax.device_put(graph.poses, rep),
        pose_valid=jax.device_put(graph.pose_valid, rep),
        edge_i=jax.device_put(graph.edge_i, row),
        edge_j=jax.device_put(graph.edge_j, row),
        edge_Z=jax.device_put(graph.edge_Z, row),
        edge_weight=jax.device_put(graph.edge_weight, row),
        edge_valid=jax.device_put(graph.edge_valid, row),
    )
    return pgo_ops.optimize(graph, config)


def ba_optimize_spmd(mesh: Mesh, problem, cam: Camera, model: str,
                     config, axis: str = "d"):
    """Observation-sharded bundle adjustment.

    The per-observation residual/Jacobian evaluation and the block
    scatter-adds into (Hpp, Hll, W, b) partition along the observation
    axis; XLA reduces the partial block systems across shards.  Poses,
    points, and the small reduced camera solve stay replicated.
    """
    from ..ops import ba as ba_ops

    row = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    problem = problem._replace(
        poses=jax.device_put(problem.poses, rep),
        pose_valid=jax.device_put(problem.pose_valid, rep),
        points=jax.device_put(problem.points, rep),
        point_valid=jax.device_put(problem.point_valid, rep),
        obs_kf=jax.device_put(problem.obs_kf, row),
        obs_lm=jax.device_put(problem.obs_lm, row),
        obs_z=jax.device_put(problem.obs_z, row),
        obs_valid=jax.device_put(problem.obs_valid, row),
    )
    return ba_ops.optimize(problem, cam, model, config)


def loop_query_spmd(mesh: Mesh, query_desc, query_valid, query_map_id,
                    db: loop_closure.DescriptorDatabase,
                    config: loop_closure.LoopDetectorConfig,
                    num_maps: int = None, axis: str = "d"):
    """Database-sharded loop-closure query (slotted ring layout).

    The [S, budget, ...] ring partitions along the BUDGET axis (every
    device holds a stripe of every map's descriptors); the per-slot
    two-best min and the vote histogram are cross-shard reductions XLA
    lowers to psum/all-reduce-min from the sharding annotations.
    """
    stripe = NamedSharding(mesh, P(None, axis))
    rep = NamedSharding(mesh, P())
    db = db._replace(
        desc=jax.device_put(db.desc, NamedSharding(mesh, P(None, axis, None))),
        points=jax.device_put(db.points,
                              NamedSharding(mesh, P(None, axis, None))),
        arena_row=jax.device_put(db.arena_row, stripe),
        valid=jax.device_put(db.valid, stripe),
        map_id=jax.device_put(db.map_id, rep),
        next=jax.device_put(db.next, rep),
    )
    query_desc = jax.device_put(query_desc, rep)
    query_valid = jax.device_put(query_valid, rep)
    return loop_closure.query(
        query_desc, query_valid, query_map_id, db, config, num_maps
    )
