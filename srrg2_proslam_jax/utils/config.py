"""Typed configuration system with a named registry and JSON round-trip.

Capability parity with the reference's BOSS object-graph configs — every
component there is a Configurable with PARAM(...) properties serialized to
``.conf`` files with #id/#pointer cross references (reference
srrg2_proslam/src/srrg2_proslam/sensor_processing/feature_extractors/
intensity_feature_extractor_base.h:24-58 and configurations/kitti.conf).

Here the equivalent is plain Python dataclasses:
  * ``@register`` adds a config class to a global registry under its class
    name, making it instantiable from JSON (the analog of
    BOSS_REGISTER_CLASS in the reference's instances.cpp files).
  * ``to_dict``/``from_dict`` recurse through nested configs, tagging each
    object with ``"type"``.
  * ``save``/``load`` round-trip whole pipeline configurations to JSON.

Configs are static hyperparameters: they are hashable pytrees-of-leaves and
are always closed over / passed static into jitted stages.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Type

_REGISTRY: Dict[str, Type] = {}


def register(cls):
    """Class decorator: make a (frozen) dataclass JSON-instantiable by name."""
    if not dataclasses.is_dataclass(cls):
        cls = dataclasses.dataclass(frozen=True)(cls)
    _REGISTRY[cls.__name__] = cls
    return cls


def _ensure_registry_populated() -> None:
    """Import every config-bearing module so JSON loads work cold.

    Registration happens at class definition; a process that only imported
    the config loader would otherwise fail to resolve type names (the
    reference's BOSS registry has the same property and solves it with the
    instances.cpp registration TUs, SURVEY.md X1).
    """
    import importlib

    for mod in (
        "srrg2_proslam_jax.ops.features",
        "srrg2_proslam_jax.ops.matching",
        "srrg2_proslam_jax.ops.ekf",
        "srrg2_proslam_jax.ops.landmark_estimators",
        "srrg2_proslam_jax.ops.pgo",
        "srrg2_proslam_jax.ops.ba",
        "srrg2_proslam_jax.models.frontend",
        "srrg2_proslam_jax.models.tracker",
        "srrg2_proslam_jax.models.loop_closure",
        "srrg2_proslam_jax.models.slam",
    ):
        importlib.import_module(mod)


def registered(name: str) -> Type:
    if name not in _REGISTRY:
        _ensure_registry_populated()
    return _REGISTRY[name]


def registry() -> Dict[str, Type]:
    return dict(_REGISTRY)


def to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"type": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = to_dict(getattr(obj, f.name))
        return out
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    return obj


def from_dict(data: Any) -> Any:
    if isinstance(data, dict) and "type" in data:
        cls = registered(data["type"])
        kwargs = {}
        field_types = {f.name: f for f in dataclasses.fields(cls)}
        for key, value in data.items():
            if key == "type":
                continue
            if key not in field_types:
                raise KeyError(f"{data['type']} has no config field {key!r}")
            kwargs[key] = from_dict(value)
        return cls(**kwargs)
    if isinstance(data, list):
        # JSON has no tuples; configs are hashable statics closed over jits,
        # so sequences always come back as tuples
        return tuple(from_dict(v) for v in data)
    if isinstance(data, dict):
        return {k: from_dict(v) for k, v in data.items()}
    return data


def save(obj: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(obj), f, indent=2)


def load(path: str) -> Any:
    with open(path) as f:
        return from_dict(json.load(f))


def replace(obj, **kwargs):
    """dataclasses.replace passthrough (convenience for tuned configs)."""
    return dataclasses.replace(obj, **kwargs)
