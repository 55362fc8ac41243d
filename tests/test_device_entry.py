"""The GPU entry points on a CPU-only backend, and the compile cache.

chip_smoke.py and bench.py measure the GPU: on a CPU-only backend they must
exit non-zero and print no result line, never fall back to the CPU.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from gp_compressor_jax.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_result(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "ok" in json.loads(lines[-1])
    except ValueError:
        return False


@pytest.mark.parametrize("where", ["repo", "bare_dir"])
def test_chip_smoke_fails_without_a_gpu(where, tmp_path):
    """In the checkout, and in a directory that holds chip_smoke.py and
    nothing else of the repo: non-zero exit, no result line."""
    if where == "repo":
        p = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    else:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        p = _run_smoke(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert p.returncode != 0, p.stdout
    assert not _printed_result(p.stdout), p.stdout
    assert "platform=cpu" in p.stdout


def test_bench_refuses_a_cpu_backend(capsys):
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.remove(REPO)
    with pytest.raises(SystemExit) as e:
        bench.main(["--headline-only"])
    assert e.value.code not in (0, None)
    assert "measures the GPU" in str(e.value.code)
    assert capsys.readouterr().out == ""


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      saved[1])


def test_compile_cache_defaults_to_a_fixed_dir_in_the_checkout(
        monkeypatch, restore_cache_config):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    cache.setup_compilation_cache(min_compile_secs=2.5)
    expected = os.path.join(REPO, ".jax_cache")
    assert cache.cache_dir() == expected
    assert jax.config.jax_compilation_cache_dir == expected
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 2.5
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_honours_the_env_var(monkeypatch, tmp_path,
                                           restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper points the cache nowhere else."""
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    sentinel = str(tmp_path / "set-by-jax")
    jax.config.update("jax_compilation_cache_dir", sentinel)
    cache.setup_compilation_cache()
    assert cache.cache_dir() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == sentinel
