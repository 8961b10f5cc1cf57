"""Compile-cache placement, and the smoke script's refusal to run off-card."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from orbslam_mapsave_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


def test_env_dir_used_as_given(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert compile_cache.cache_dir() == str(tmp_path / "cc")


def test_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == str(REPO / ".jax_cache")
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_enable_points_jax_at_cache_dir():
    # conftest already enabled it; a second call is idempotent
    assert compile_cache.enable() == compile_cache.cache_dir()
    assert jax.config.jax_compilation_cache_dir == compile_cache.cache_dir()


def test_smoke_device_check_refuses_cpu():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    assert jax.default_backend() == "cpu"
    with pytest.raises(SystemExit) as exc:
        chip_smoke.check_device()
    assert exc.value.code not in (0, None)


def test_smoke_alone_fails_without_result(tmp_path):
    """Copied without the package, the script exits non-zero, prints no
    result line."""
    (tmp_path / "chip_smoke.py").write_bytes(
        (REPO / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
