"""Operator methods on ELL/BSR containers (diagonal, shift, axpy) and the
solvers running on non-DIA formats.

The reference's solvers operate on BCRSMatrix with any square block size
(umfpacktools.hh:57-95 handles the general case); our solver layer is
format-agnostic through spmm + these methods.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from dune_eigensolver_tpu.sparse import problems
from dune_eigensolver_tpu.sparse.formats import (
    bsr_from_scipy,
    ell_from_scipy,
)


def _lap_scipy(N=12):
    return problems.laplacian_dirichlet_2d(N, dtype=np.float64).to_scipy()


def test_ell_diagonal_shift_axpy():
    S = _lap_scipy()
    A = ell_from_scipy(S, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(A.diagonal()), S.diagonal())

    A2 = A.with_shifted_diagonal(0.25)
    np.testing.assert_allclose(
        np.asarray(A2.to_scipy().todense()),
        np.asarray((S + 0.25 * sp.identity(S.shape[0])).todense()),
    )

    B = ell_from_scipy(sp.identity(S.shape[0]).tocsr(), dtype=np.float64)
    A3 = A.axpy(2.0, B)
    np.testing.assert_allclose(
        np.asarray(A3.to_scipy().todense()),
        np.asarray((S + 2.0 * sp.identity(S.shape[0])).todense()),
    )


def test_bsr_diagonal_shift_axpy():
    S = _lap_scipy(12)  # n=144, divisible by 2 and 3
    for blk in [(2, 2), (3, 3)]:
        A = bsr_from_scipy(S, block=blk, dtype=np.float64)
        np.testing.assert_allclose(np.asarray(A.diagonal()), S.diagonal())
        A2 = A.with_shifted_diagonal(0.5)
        np.testing.assert_allclose(
            np.asarray(A2.to_scipy().todense()),
            np.asarray((S + 0.5 * sp.identity(S.shape[0])).todense()),
        )
        A3 = A.axpy(-1.0, A)
        assert abs(A3.to_scipy()).sum() == 0.0


def test_standard_largest_on_ell_and_bsr():
    from dune_eigensolver_tpu.oracle.analytic import (
        eigenvalues_laplace_dirichlet_2d,
    )
    from dune_eigensolver_tpu.solvers import standard_largest

    N = 12
    S = _lap_scipy(N)
    anal = eigenvalues_laplace_dirichlet_2d(N)[::-1][:4]
    for A in [
        ell_from_scipy(S, dtype=np.float64),
        bsr_from_scipy(S, block=(2, 2), dtype=np.float64),
    ]:
        res = standard_largest(A, nev=4, tol=1e-10, maxiter=3000)
        np.testing.assert_allclose(
            np.asarray(res.eigenvalues), anal, atol=1e-5
        )


def test_standard_inverse_on_ell():
    # non-DIA operand -> host-LU gather-trisolve default engine
    from dune_eigensolver_tpu.oracle.analytic import (
        eigenvalues_laplace_dirichlet_2d,
    )
    from dune_eigensolver_tpu.solvers import standard_inverse

    N = 10
    S = _lap_scipy(N)
    A = ell_from_scipy(S, dtype=np.float64)
    res = standard_inverse(A, nev=4, tol=1e-10, maxiter=500, shift=-1e-3)
    anal = eigenvalues_laplace_dirichlet_2d(N)[:4]
    np.testing.assert_allclose(np.asarray(res.eigenvalues), anal, atol=1e-6)


def test_sharded_standard_inverse():
    from dune_eigensolver_tpu.dist import make_mesh, sharded_standard_inverse
    from dune_eigensolver_tpu.oracle.analytic import (
        eigenvalues_laplace_dirichlet_2d,
    )

    N = 16
    A = problems.laplacian_dirichlet_2d(N, dtype=np.float64)
    res = sharded_standard_inverse(
        A,
        nev=4,
        tol=1e-10,
        maxiter=400,
        shift=-1e-3,
        mesh=make_mesh(4),
        cg_rtol=1e-10,
    )
    anal = eigenvalues_laplace_dirichlet_2d(N)[:4]
    np.testing.assert_allclose(np.asarray(res.eigenvalues), anal, atol=1e-6)


def test_weak_scaling_harness():
    import pytest

    from dune_eigensolver_tpu.bench.scaling import _EFF_FLOOR, weak_scaling_spmm

    # large enough that the per-iteration time sits above the timer floor on
    # a CPU host (a 256-row strip measured under 100 ns/iter and tripped
    # the eff=nan guard); the guard itself is unit-tested in test_dist.py
    recs = weak_scaling_spmm(
        rows_per_device=16384, m=8, n_iter=3, device_counts=[1, 2]
    )
    assert len(recs) == 2
    assert all(np.isfinite(r["t_iter"]) for r in recs)
    if recs[0]["t_iter"] <= _EFF_FLOOR:
        pytest.skip("host timer floor reached even at 16k rows/device")
    assert recs[0]["efficiency"] == 1.0
