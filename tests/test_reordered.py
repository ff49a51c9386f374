"""RCM bandwidth-reduced direct solve for general (non-DIA) operands."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spl

from dune_eigensolver_tpu.factorize.reordered import (
    rcm_banded_inverse_factory,
    rcm_bandwidth,
)
from dune_eigensolver_tpu.sparse import problems
from dune_eigensolver_tpu.sparse.formats import ell_from_scipy


def _scrambled_laplacian(N=20, seed=0):
    """Laplacian with rows/cols randomly permuted: large raw bandwidth, small
    after RCM."""
    S = problems.laplacian_dirichlet_2d(N, dtype=np.float64).to_scipy()
    S = S + 0.1 * sp.identity(S.shape[0])
    rng = np.random.default_rng(seed)
    p = rng.permutation(S.shape[0])
    return sp.csr_matrix(S[p][:, p])


def test_rcm_reduces_bandwidth():
    S = _scrambled_laplacian()
    raw_bw = int(np.abs(sp.coo_matrix(S).row - sp.coo_matrix(S).col).max())
    _, bw = rcm_bandwidth(S)
    assert bw < raw_bw / 4  # scrambled ~n, RCM ~grid width


def test_rcm_banded_solve_matches_scipy():
    S = _scrambled_laplacian()
    A = ell_from_scipy(S, dtype=np.float64)
    aux, fn = rcm_banded_inverse_factory(A, C=128, dtype=np.float64)
    n = S.shape[0]
    B = np.random.default_rng(1).standard_normal((n, 8))
    X = np.asarray(fn(aux, B))
    Xref = spl.spsolve(S.tocsc(), B)
    assert np.abs(X - Xref).max() / np.abs(Xref).max() < 1e-10


def test_default_factory_routes_ell_to_rcm():
    from dune_eigensolver_tpu.factorize import default_inverse_factory

    A = ell_from_scipy(_scrambled_laplacian(), dtype=np.float64)
    result = default_inverse_factory(A)
    assert isinstance(result, tuple) and len(result) == 2  # (aux, fn) pair


def test_standard_inverse_on_scrambled_ell():
    # end to end: solver on a scrambled ELL operand routes through RCM+banded
    from dune_eigensolver_tpu.oracle.analytic import (
        eigenvalues_laplace_dirichlet_2d,
    )
    from dune_eigensolver_tpu.solvers import standard_inverse

    N = 14
    S = problems.laplacian_dirichlet_2d(N, dtype=np.float64).to_scipy()
    rng = np.random.default_rng(3)
    p = rng.permutation(S.shape[0])
    Sp = sp.csr_matrix(S[p][:, p])
    A = ell_from_scipy(Sp, dtype=np.float64)
    res = standard_inverse(A, nev=4, tol=1e-10, maxiter=500, shift=-1e-3)
    anal = eigenvalues_laplace_dirichlet_2d(N)[:4]
    np.testing.assert_allclose(np.asarray(res.eigenvalues), anal, atol=1e-6)


def test_rcm_bandwidth_keeps_an_already_banded_ordering():
    # lexicographic grid operators are banded already; RCM would widen
    # them (its level sets run along the grid's diagonals)
    A, _ = problems.elasticity_2d(12, dtype=np.float64)
    S = A.to_scipy().tocoo()
    natural = int(np.abs(S.row - S.col).max())
    perm, bw = rcm_bandwidth(A)
    assert bw == natural
    np.testing.assert_array_equal(perm, np.arange(A.shape[0]))
    aux, fn = rcm_banded_inverse_factory(A, C=64, dtype=np.float64)
    B = np.random.default_rng(2).standard_normal((A.shape[0], 4))
    X = np.asarray(fn(aux, B))
    Xref = spl.spsolve(A.to_scipy().tocsc(), B)
    assert np.abs(X - Xref).max() / np.abs(Xref).max() < 1e-10
