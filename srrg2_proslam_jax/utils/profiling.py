"""Profiling: scoped host timers + device trace capture.

Capability parity with the reference's Profiler mixin and PROFILE_TIME
scoped timers (reference srrg2_proslam sensor_processing/feature_extractors/
intensity_feature_extractor_base.cpp:50 etc., enabled globally by
Profiler::enable_logging, benchmarks/benchmark_kitti.cpp:27) — here a
process-global registry of named wall-clock accumulators plus an optional
jax.profiler trace for device-side breakdowns (SURVEY.md §5.1).

Usage:
    from srrg2_proslam_jax.utils import profiling
    profiling.enable()
    with profiling.profile_time("adaptor"):
        ...
    print(profiling.report())

Device traces (viewable in TensorBoard / Perfetto):
    with profiling.device_trace("/tmp/jax_trace"):
        run_pipeline()
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

_ENABLED = False
_ACCUM: Dict[str, list] = defaultdict(lambda: [0, 0.0])  # name -> [calls, secs]


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def reset() -> None:
    _ACCUM.clear()


@contextlib.contextmanager
def profile_time(name: str) -> Iterator[None]:
    """Scoped wall-clock timer (PROFILE_TIME analog). No-op unless enabled."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        cell = _ACCUM[name]
        cell[0] += 1
        cell[1] += time.perf_counter() - t0


def stats() -> Dict[str, dict]:
    return {
        name: {"calls": calls, "total_s": total,
               "mean_ms": (total / calls * 1000.0) if calls else 0.0}
        for name, (calls, total) in _ACCUM.items()
    }


def report() -> str:
    """Human-readable per-scope timing table (mean ms, calls, total)."""
    lines = ["profile_time report:"]
    for name, s in sorted(stats().items(), key=lambda kv: -kv[1]["total_s"]):
        lines.append(
            f"  {name:32s} {s['mean_ms']:9.3f} ms/call  x{s['calls']:<6d} "
            f"total {s['total_s']:8.3f} s"
        )
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler device trace into ``log_dir``."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
