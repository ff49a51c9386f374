"""Loud-degradation contract: every silent engine downgrade emits a
greppable ``FALLBACK:`` line (VERDICT r3 ask #4; reference analogue is the
unconditional verbose engine reporting at umfpacktools.hh:112-123)."""

import numpy as np
import pytest

from dune_eigensolver_tpu.utils.vlog import warn_fallback


def test_pick_inner_downgrade_warns(capfd):
    from dune_eigensolver_tpu.dist.sharded import _pick_inner

    class _Dia:
        offsets = (-400, 0, 400)

    capfd.readouterr()
    assert _pick_inner("schwarz", _Dia(), nloc=64) == "cg"
    err = capfd.readouterr().err
    assert "FALLBACK:" in err and "schwarz" in err
    # in-range bandwidth stays on schwarz, silently
    capfd.readouterr()
    assert _pick_inner("schwarz", _Dia(), nloc=4096) == "schwarz"
    assert "FALLBACK" not in capfd.readouterr().err


def test_warn_fallback_format(capfd):
    warn_fallback("unit probe")
    err = capfd.readouterr().err
    assert err.startswith("FALLBACK: unit probe")


def test_cli_b_identity_guard():
    from dune_eigensolver_tpu.cli import eigenvalues_test
    from dune_eigensolver_tpu.config import ParameterTree

    pt = ParameterTree()
    pt["ev.N"] = 16
    pt["ev.method"] = "lobpcg"
    pt["ev.maxiter"] = 5
    pt["ev.verbose"] = 0
    pt["ev.b_identity"] = 1
    with pytest.raises(ValueError, match="b_identity"):
        eigenvalues_test(pt)


def test_sharded_mg_geometry_validates_outside_trace():
    from dune_eigensolver_tpu.dist.mg import sharded_mg_geometry
    from dune_eigensolver_tpu.sparse import problems

    # a structurally valid grid whose coarse hierarchy is empty must raise
    # in the geometry check (NOT mid-trace): 4x4 with min_coarse=6 has no
    # level above min_coarse (and 4 planes/shard at P=1, so the planes
    # check passes and the levels check is what fires)
    A = problems.laplacian_dirichlet_2d(4, dtype=np.float32)
    with pytest.raises(ValueError, match="coarse level"):
        sharded_mg_geometry(A.offsets, 16, 16, 1, min_coarse=6)
    # the good case returns the dims
    A = problems.laplacian_dirichlet_2d(32, dtype=np.float32)
    assert sharded_mg_geometry(A.offsets, 32 * 32, 32 * 32, 2) == (32, 32)
