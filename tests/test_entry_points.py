"""The compile-cache helper and chip_smoke.py's refusal to run off the GPU."""
import os
import shutil
import subprocess
import sys

import jax

from srrg2_proslam_jax.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_honours_env_var(monkeypatch):
    assert compile_cache.compile_cache_dir(
        {compile_cache.ENV_VAR: "/some/cache"}) == "/some/cache"
    # with the variable set, the helper leaves JAX's own reading of it alone
    monkeypatch.setenv(compile_cache.ENV_VAR, "/some/cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == "/some/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_left_off_on_the_cpu(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_is_inside_the_checkout():
    path = compile_cache.compile_cache_dir({})
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _smoke(cwd, *args, timeout=120):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_chip_smoke_refuses_the_cpu():
    out = _smoke(REPO)
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    # the rehearsal flag gets past the GPU check: what fails is the import
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _smoke(tmp_path, "--cpu-rehearsal")
    assert out.returncode != 0
    assert "ModuleNotFoundError" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_rehearsal_runs_every_phase():
    out = _smoke(REPO, "--cpu-rehearsal", timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    phases = [ln for ln in out.stdout.splitlines() if ln.startswith("[")]
    assert [ln.split("]")[0] for ln in phases] == [
        "[1 device", "[2 kernels vs reference", "[3 chunked SLAM",
        "[4 per-frame SLAM", "[5 KITTI-width VO", "[6 RGB-D"]
    assert all("PASS" in ln for ln in phases)
    assert '"ok"' not in out.stdout     # no result line off the GPU
