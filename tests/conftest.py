"""Test configuration: force CPU with 8 virtual devices.

Per SURVEY.md §4 ("distributed without a cluster"): multi-device
sharding is validated on a virtual CPU mesh; the GPU is reserved for
chip_smoke.py and the benchmarks.  Env vars must be set before jax is
imported anywhere.  Tests that need the GPU carry the ``gpu`` marker and
skip here.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
prev = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in prev:
    os.environ["XLA_FLAGS"] = (
        prev + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

# Persistent compilation cache: recompiling the scan/beam executables on
# every pytest run dominates suite time otherwise.
from stvd.utils import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=0.5)

from stvd.config import ModelConfig  # noqa: E402
from stvd.data.batching import synthetic_dataset  # noqa: E402
from stvd.model.decoder import init_params  # noqa: E402


def small_cfg(**kw) -> ModelConfig:
    base = dict(n_words=48, dim_word=16, dim=24, ctx_dim=32, n_frames=6,
                compute_dtype="float32")
    base.update(kw)
    return ModelConfig(**base)


@pytest.fixture(scope="session")
def cfg():
    return small_cfg()


@pytest.fixture(scope="session")
def spatial_cfg():
    return small_cfg(use_spatial=True, n_regions=4, region_dim=16)


@pytest.fixture(scope="session")
def dataset(cfg):
    return synthetic_dataset(n_videos=8, captions_per_video=2,
                             k=cfg.n_frames, d=cfg.ctx_dim, maxlen=10, seed=0)


@pytest.fixture(scope="session")
def params(cfg):
    return init_params(jax.random.PRNGKey(0), cfg)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU and skips without one "
        "(chip_smoke.py runs the same checks on the card)")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none (decided
    here, at run time, never while modules are collected)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py covers this on "
                    "the card")
    return devs[0]
