"""Checkpoint / resume for the SLAM session state.

The reference has no mid-run checkpointing — its persistence is BOSS
serialization of configs and message logs (SURVEY.md §5.4, which calls for
an accelerator build to add real map/graph checkpointing since clusters
fail more often than laptops).  This module snapshots the full GraphSLAM session — tracker
state, pose graph, loop-closure database, finalized-map arenas, and frame
bookkeeping — to a single compressed npz, and restores it into a fresh
GraphSLAM so a run resumes mid-sequence.
"""
from __future__ import annotations

import json
from typing import TYPE_CHECKING

import numpy as np
import jax
import jax.numpy as jnp

if TYPE_CHECKING:
    from ..models.slam import GraphSLAM

_PREFIXES = ("tracker", "graph", "db")


def _flatten(prefix: str, tree) -> dict:
    leaves = jax.tree_util.tree_leaves(tree)
    return {f"{prefix}_{i}": np.asarray(v) for i, v in enumerate(leaves)}


def _unflatten(prefix: str, template, data: dict):
    leaves = jax.tree_util.tree_leaves(template)
    treedef = jax.tree_util.tree_structure(template)
    new = [jnp.asarray(data[f"{prefix}_{i}"]) for i in range(len(leaves))]
    return jax.tree_util.tree_unflatten(treedef, new)


def save(slam: "GraphSLAM", path: str) -> None:
    """Snapshot a GraphSLAM session to ``path`` (.npz)."""
    from ..models.slam import FrameRecord  # noqa: F401  (doc link)

    # drain the speculative pipeline and compact the in-flight database
    # entries so the snapshot is a consistent, fully-consumed state
    slam.flush()
    slam._materialize_db_entries()
    slam._materialize_map_arenas()
    arrays = {}
    arrays.update(_flatten("tracker", slam.tracker_state))
    arrays.update(_flatten("graph", slam.graph))
    arrays.update(_flatten("db", slam.db))
    for map_id, arena in slam._map_arenas.items():
        arrays.update(_flatten(f"arena{map_id}", arena))
    for map_id, entry in slam._db_entries.items():
        arrays[f"dbent{map_id}_desc"] = entry["desc"]
        arrays[f"dbent{map_id}_points"] = entry["points"]
        arrays[f"dbent{map_id}_rows"] = entry["rows"]
    meta = {
        "num_maps": slam.num_maps,
        "current_map": slam.current_map,
        "num_edges": slam.num_edges,
        "num_closures": slam.num_closures,
        "num_relocalizations": slam.num_relocalizations,
        "frames_in_current_map": slam._frames_in_current_map,
        "frame_count": slam._frame_count,
        "status": slam.status,
        "model": slam.model,
        "db_entry_ids": list(slam._db_entries),
        "num_db_evictions": slam.num_db_evictions,
        "map_arena_ids": sorted(slam._map_arenas),
        "frames": [
            {"timestamp": f.timestamp, "local_map_index": f.local_map_index,
             "T_lm_robot": f.T_lm_robot.tolist()}
            for f in slam.frames
        ],
    }
    arrays["_meta_json"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load(slam: "GraphSLAM", path: str) -> "GraphSLAM":
    """Restore a snapshot into a freshly-constructed GraphSLAM (same config)."""
    from ..models.slam import FrameRecord

    data = np.load(path)
    meta = json.loads(bytes(data["_meta_json"]).decode())
    slam.tracker_state = _unflatten("tracker", slam.tracker_state, data)
    slam.graph = _unflatten("graph", slam.graph, data)
    slam.db = _unflatten("db", slam.db, data)
    slam.num_maps = meta["num_maps"]
    slam.current_map = meta["current_map"]
    slam.num_edges = meta["num_edges"]
    slam.num_closures = meta["num_closures"]
    slam.num_relocalizations = meta["num_relocalizations"]
    slam._frames_in_current_map = meta["frames_in_current_map"]
    slam._frame_count = meta["frame_count"]
    slam.status = meta["status"]
    slam.model = meta["model"]
    slam._db_entries = {
        mid: dict(desc=data[f"dbent{mid}_desc"],
                  points=data[f"dbent{mid}_points"],
                  rows=data[f"dbent{mid}_rows"])
        for mid in meta["db_entry_ids"]
    }
    slam.num_db_evictions = meta.get("num_db_evictions", 0)
    slam._map_arenas = {
        map_id: jax.tree_util.tree_map(
            np.asarray,
            _unflatten(f"arena{map_id}", slam.tracker_state.arena, data),
        )
        for map_id in meta["map_arena_ids"]
    }
    slam.frames = [
        FrameRecord(timestamp=f["timestamp"],
                    local_map_index=f["local_map_index"],
                    T_lm_robot=np.asarray(f["T_lm_robot"], np.float32))
        for f in meta["frames"]
    ]
    return slam
