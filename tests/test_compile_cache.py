"""Placement of JAX's persistent compilation cache (stvd.utils)."""

import os
import subprocess
import sys

import jax
import pytest

from stvd import utils

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = (
    "import jax; from stvd.utils import enable_compile_cache; "
    "enable_compile_cache(0.0); jax.jit(lambda x: x * 3 + 1)(2.0)"
    ".block_until_ready(); print(jax.config.jax_compilation_cache_dir)")


def _run(env_update, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_update, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_default_dir_is_fixed_inside_the_checkout():
    assert utils.DEFAULT_CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_tests_use_the_same_placement():
    """conftest turns the cache on through enable_compile_cache, so the
    test process follows the same rule as the program."""
    assert jax.config.jax_compilation_cache_dir == utils.compile_cache_dir()


def test_env_var_places_the_cache(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the cache lands there and no
    other directory is set in code."""
    target = tmp_path / "cache"
    used = _run({"JAX_COMPILATION_CACHE_DIR": str(target)})
    assert used == str(target)
    assert target.is_dir() and any(target.iterdir())


def test_unset_env_var_falls_back_to_checkout_dir():
    used = _run({}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert used == utils.DEFAULT_CACHE_DIR


@pytest.mark.parametrize("value,expected", [
    ("/somewhere/else", "/somewhere/else"), ("", None)])
def test_compile_cache_dir_reads_env(monkeypatch, value, expected):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", value)
    assert utils.compile_cache_dir() == (expected or utils.DEFAULT_CACHE_DIR)
