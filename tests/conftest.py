"""Test harness config: run everything on a virtual 8-device CPU mesh.

Sharding is validated on `xla_force_host_platform_device_count=8` CPU
devices. This must run before jax initializes, hence the env mutation at
import time. `JAX_PLATFORMS` defaults to cpu; tests marked `gpu` need a card
and run only where it is set to cuda (they skip on every other backend).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng():
    # function-scoped: every test sees the same deterministic stream
    # regardless of execution order
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def synthetic_tum(tmp_path_factory):
    """A small rendered TUM-format RGB-D sequence with exact ground truth."""
    from orbslam_mapsave_tpu.io import synthetic

    out = tmp_path_factory.mktemp("tumseq")
    K = np.array([[320.0, 0, 320.0], [0, 320.0, 240.0], [0, 0, 1.0]])
    poses = synthetic.orbit_trajectory(12)
    synthetic.write_tum_sequence(out, K, poses, width=640, height=480, seed=3)
    return {"root": out, "K": K, "poses": poses}


@pytest.fixture()
def gpu():
    """Skips a card-only test on any backend but the GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (run with JAX_PLATFORMS=cuda on the "
                    "card; chip_smoke.py runs the same comparisons there)")
