"""JAX persistent compilation cache at a fixed, per-checkout location.

The cache key includes the directory, so the directory must not move
between runs: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it
(JAX reads that variable itself), otherwise ``<repo>/.jax_cache``.
Entry points call :func:`enable_compile_cache` once, before their first
compile.  On the CPU backend it sets nothing: serializing the large
chunked-stepping executable crashes XLA:CPU's export (tests/conftest.py).
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(environ=os.environ) -> str:
    """The directory the persistent compilation cache uses."""
    return environ.get(ENV_VAR) or os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache():
    """Turn the persistent cache on; returns its directory (None on CPU)."""
    import jax

    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    if jax.default_backend() == "cpu":
        return None
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
