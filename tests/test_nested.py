"""Nested-iteration LOBPCG (solvers/nested.py): coarse-hierarchy
derivation, prolongation seeding, and end-to-end spectra vs the analytic
Dirichlet eigenvalues. The full-size run (the 10.1M-dof north star) is a
phase of chip_smoke.py."""

import numpy as np
import pytest

import jax.numpy as jnp

from dune_eigensolver_tpu.oracle.analytic import (
    eigenvalues_laplace_dirichlet_2d,
    eigenvalues_laplace_dirichlet_3d,
)
from dune_eigensolver_tpu.solvers import lobpcg_generalized, lobpcg_nested
from dune_eigensolver_tpu.solvers.nested import _coarse_operator, prolong_vectors
from dune_eigensolver_tpu.sparse import problems
from dune_eigensolver_tpu.sparse.formats import DIAMatrix


def _ident(n, dtype=np.float64):
    return DIAMatrix(
        data=jnp.ones((1, n), dtype), offsets=(0,), shape=(n, n)
    )


def test_coarse_operator_matches_rediscretization():
    # same-coefficient rediscretization of the 3D Laplacian on the halved
    # grid must equal the problems-builder operator exactly
    A = problems.laplacian_dirichlet_3d(16, dtype=np.float64)
    Ac = _coarse_operator(A, (8, 8, 8))
    Aref = problems.laplacian_dirichlet_3d(8, dtype=np.float64)
    assert Ac.offsets == Aref.offsets
    np.testing.assert_allclose(np.asarray(Ac.data), np.asarray(Aref.data))


def test_nested_3d_vs_analytic():
    N = 16
    A = problems.laplacian_dirichlet_3d(N, dtype=np.float64)
    res = lobpcg_nested(
        A, _ident(A.shape[0]), nev=4, tol=1e-6, maxiter=300,
        min_coarse=6, b_identity=True,
    )
    anal = eigenvalues_laplace_dirichlet_3d(N)[:4]
    np.testing.assert_allclose(np.asarray(res.eigenvalues), anal, atol=1e-6)
    assert bool(res.converged)


def test_nested_2d_vs_analytic_and_plain():
    N = 32
    A = problems.laplacian_dirichlet_2d(N, dtype=np.float64)
    B = _ident(A.shape[0])
    res = lobpcg_nested(
        A, B, nev=4, tol=1e-7, maxiter=400, min_coarse=12, b_identity=True,
    )
    anal = eigenvalues_laplace_dirichlet_2d(N)[:4]
    np.testing.assert_allclose(np.asarray(res.eigenvalues), anal, atol=1e-6)
    # the seeded fine solve must not take more iterations than the plain one
    plain = lobpcg_generalized(
        A, B, nev=4, tol=1e-7, maxiter=400, b_identity=True,
    )
    assert int(res.iterations) <= int(plain.iterations)


def test_nested_requires_b_identity():
    A = problems.laplacian_dirichlet_2d(16, dtype=np.float64)
    with pytest.raises(ValueError, match="b_identity"):
        lobpcg_nested(A, _ident(A.shape[0]), nev=2, tol=1e-4, maxiter=50)


def test_nested_rejects_unstructured_offsets():
    n = 64
    A = DIAMatrix(
        data=jnp.ones((1, n), jnp.float64) * 2.0, offsets=(0,), shape=(n, n)
    )
    with pytest.raises(ValueError, match="structured"):
        lobpcg_nested(
            A, _ident(n), nev=2, tol=1e-4, maxiter=50, b_identity=True
        )


def test_prolong_vectors_shapes_and_smoothness():
    # prolonging the coarse-grid sine mode approximates the fine-grid sine
    Nc, Nf = 8, 16
    xc = (np.arange(1, Nc + 1)) / (Nc + 1)
    yc = np.sin(np.pi * xc)
    Yc = np.outer(yc, yc).reshape(-1, 1)  # 2D fundamental mode
    Yf = np.asarray(prolong_vectors(jnp.asarray(Yc), (Nc, Nc), (Nf, Nf)))
    assert Yf.shape == (Nf * Nf, 1)
    xf = (np.arange(1, Nf + 1)) / (Nf + 1)
    ref = np.outer(np.sin(np.pi * xf), np.sin(np.pi * xf)).reshape(-1)
    # normalize both (prolongation does not preserve scale exactly)
    a = Yf[:, 0] / np.linalg.norm(Yf[:, 0])
    b = ref / np.linalg.norm(ref)
    # the grids don't nest exactly (h_f = 1/17 vs h_c/2 = 1/18, the same
    # O(h) offset the production pipeline has), so the overlap is high but
    # not 1 - eps
    assert abs(float(a @ b)) > 0.99
