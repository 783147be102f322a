import json

from srrg2_proslam_jax.utils import config as cfg
from srrg2_proslam_jax.ops.features import FeatureExtractorConfig
from srrg2_proslam_jax.ops.matching import (
    BruteforceMatcherConfig,
    EpipolarMatcherConfig,
    ProjectiveMatcherConfig,
)


def test_roundtrip(tmp_path):
    c = ProjectiveMatcherConfig(radius_stages=(5.0, 10.0), descriptor_stages=(25.0, 50.0))
    p = tmp_path / "c.json"
    cfg.save(c, str(p))
    back = cfg.load(str(p))
    assert tuple(back.radius_stages) == (5.0, 10.0)
    assert back.lowe_ratio == c.lowe_ratio


def test_nested_roundtrip(tmp_path):
    data = {
        "extractor": FeatureExtractorConfig(detector_threshold=20.0),
        "stereo": EpipolarMatcherConfig(),
        "bf": BruteforceMatcherConfig(),
    }
    p = tmp_path / "pipeline.json"
    cfg.save(data, str(p))
    back = cfg.load(str(p))
    assert back["extractor"].detector_threshold == 20.0
    assert isinstance(back["stereo"], EpipolarMatcherConfig)
    # file is genuinely readable json with type tags
    raw = json.loads(p.read_text())
    assert raw["extractor"]["type"] == "FeatureExtractorConfig"


def test_defaults_match_reference_kitti_conf():
    """Key thresholds mirror configurations/kitti.conf of the reference."""
    assert FeatureExtractorConfig().detector_threshold == 15.0
    assert EpipolarMatcherConfig().maximum_disparity_px == 100.0
    assert BruteforceMatcherConfig().maximum_descriptor_distance == 50.0
    assert ProjectiveMatcherConfig().descriptor_stages[-1] == 25.0
