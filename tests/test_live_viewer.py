"""Live viewer (F13 analog): HTTP server serves the SLAM state + page.

The reference runs an interactive 3-D canvas on a viewer thread
(example_slam_3d.cpp:80,127-144); the headless analog is an embedded HTTP
server whose page draws the top-down trajectory/map and whose
``/state.json`` endpoint feeds dashboards.  This test drives a small SLAM
run, refreshes the viewer, and asserts both endpoints serve the live state.
"""
import json
import urllib.request

import numpy as np

from srrg2_proslam_jax.models.slam import (
    GraphSLAM, GraphSLAMConfig, SplittingConfig,
)
from srrg2_proslam_jax.viz import LiveViewer, snapshot
from tests.test_slam import CAM
from tests.test_speculation import _frames_linear


def test_live_viewer_serves_state(rng):
    frames = _frames_linear(rng, n_frames=6)
    slam = GraphSLAM(CAM, GraphSLAMConfig(
        splitting=SplittingConfig(maximum_translation_m=1.2),
        arena_capacity=1024, enable_loop_closing=False))
    viewer = LiveViewer(port=0, quiet=True)
    try:
        for i, (p, d, ok) in enumerate(frames):
            slam.process(p, d, ok, timestamp=0.1 * i)
        viewer.update(slam)
        state = json.loads(urllib.request.urlopen(
            viewer.url + "state.json", timeout=10).read())
        assert state["frames"] == 6
        assert state["maps"] == slam.num_maps
        assert len(state["trajectory"]) == 6
        assert len(state["landmarks"]) > 50
        # the trajectory advanced along the forward axis
        t = np.asarray(state["trajectory"])
        assert np.linalg.norm(t[-1] - t[0]) > 1.0
        page = urllib.request.urlopen(viewer.url, timeout=10).read()
        assert b"canvas" in page and b"state.json" in page
    finally:
        viewer.close()


def test_snapshot_closure_edges(rng):
    """Closure events map to frame-index pairs the page can draw."""
    from srrg2_proslam_jax.models.loop_closure import LoopDetectorConfig
    from tests.test_speculation import _frames_out_and_back

    frames = _frames_out_and_back(rng)
    slam = GraphSLAM(CAM, GraphSLAMConfig(
        splitting=SplittingConfig(maximum_translation_m=1.2),
        loop=LoopDetectorConfig(minimum_age_difference=1),
        arena_capacity=1024, database_capacity=8192,
        max_db_descriptors_per_map=512, enable_loop_closing=True))
    for i, (p, d, ok) in enumerate(frames):
        slam.process(p, d, ok, timestamp=0.1 * i)
    slam.flush()
    snap = snapshot(slam)
    assert snap["closures"] >= 1
    assert len(snap["closure_edges"]) >= 1
    for a, b in snap["closure_edges"]:
        assert 0 <= a < snap["frames"] and 0 <= b < snap["frames"]
