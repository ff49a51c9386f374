"""The backend is decided in one place (dune_eigensolver_tpu/backend.py);
the compile cache follows one path policy; chip_smoke.py refuses to run
without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

from dune_eigensolver_tpu import backend
from dune_eigensolver_tpu.sparse import problems

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_backend_reports_jax_backend():
    assert backend.platform() == jax.default_backend() == "cpu"
    assert backend.dia_spmm_mode() == "xla"
    rec = backend.device_record()
    assert rec == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


def test_backend_hides_nothing(monkeypatch):
    # no exception handler and no default: a failing backend query
    # propagates instead of silently choosing a path
    def broken():
        raise RuntimeError("no backend")

    monkeypatch.setattr(jax, "default_backend", broken)
    with pytest.raises(RuntimeError, match="no backend"):
        backend.platform()
    with pytest.raises(RuntimeError, match="no backend"):
        backend.dia_spmm_mode()


@pytest.mark.parametrize("mode", ["padded", "xla"])
def test_engine_and_sharded_follow_backend(monkeypatch, mode):
    from dune_eigensolver_tpu.dist.sharded import _pick_spmm
    from dune_eigensolver_tpu.solvers.engine import make_engine

    monkeypatch.setattr(backend, "dia_spmm_mode", lambda: mode)
    A = problems.laplacian_dirichlet_2d(8, dtype=np.float32)
    _, _, layout, spec = make_engine(A, None, m=8)
    assert spec.padded == (mode == "padded")
    assert (layout is not None) == (mode == "padded")
    assert _pick_spmm(None) == mode
    assert _pick_spmm("xla") == "xla"  # an explicit request wins


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from dune_eigensolver_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.cache_dir() == str(tmp_path)
    # JAX reads the variable itself; the program sets no other directory
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    from dune_eigensolver_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.cache_dir()
    assert d == os.path.join(REPO, ".jax_cache") == compile_cache.cache_dir()
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_gpu():
    p = _run_smoke(REPO)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "needs a GPU" in p.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
