"""Transposed-layout ortho + spmm_t dispatch.

The _t functions are the solver-internal hot path; the column-layout
wrappers are covered by test_ortho.py. Here: direct checks, the guarded
layout invariant, and the O(m/b) trace-scaling property (large m compiles)."""

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dune_eigensolver_tpu.ops.ortho import (
    b_orthonormalize_blocked_t,
    orthonormalize_blocked_t,
)
from dune_eigensolver_tpu.sparse import problems
from dune_eigensolver_tpu.sparse.spmm import spmm, spmm_t


def test_orthonormalize_t_basic():
    m, n = 16, 300
    X = jax.random.normal(jax.random.PRNGKey(0), (m, n), dtype=jnp.float64)
    Q = orthonormalize_blocked_t(X, block=8)
    G = np.asarray(Q @ Q.T)
    np.testing.assert_allclose(G, np.eye(m), atol=1e-10)
    # nested-subspace property: rows 0..7 span the same space as X rows 0..7
    r = np.linalg.matrix_rank(np.vstack([np.asarray(X)[:8], np.asarray(Q)[:8]]))
    assert r == 8


def test_orthonormalize_t_guard_columns_stay_zero():
    m, n = 8, 200
    X = jax.random.normal(jax.random.PRNGKey(1), (m, n), dtype=jnp.float64)
    Xg = jnp.pad(X, ((0, 0), (64, 64)))
    Qg = orthonormalize_blocked_t(Xg, block=8)
    assert np.all(np.asarray(Qg[:, :64]) == 0)
    assert np.all(np.asarray(Qg[:, -64:]) == 0)
    # and equals the unguarded result on the interior
    Q = orthonormalize_blocked_t(X, block=8)
    np.testing.assert_allclose(np.asarray(Qg[:, 64:-64]), np.asarray(Q), atol=1e-10)


def test_b_orthonormalize_t_basic():
    N = 20
    B = problems.laplacian_dirichlet_2d(N, dtype=np.float64)
    n = B.shape[0]
    m = 16
    X = jax.random.normal(jax.random.PRNGKey(2), (m, n), dtype=jnp.float64)
    Q, norm = b_orthonormalize_blocked_t(B, X, block=8)
    BQ = spmm_t(B, Q)
    G = np.asarray(Q @ BQ.T)
    np.testing.assert_allclose(G, np.eye(m), atol=1e-8)
    assert float(norm) >= 0


def test_large_m_trace_scales():
    # VERDICT #4: m=256 ortho must compile in seconds (fori-loop trace is
    # O(m/b), not O((m/b)^2) unrolled concats)
    m, n = 256, 512
    X = jax.random.normal(jax.random.PRNGKey(3), (m, n), dtype=jnp.float32)
    t0 = time.perf_counter()
    Q = jax.jit(lambda x: orthonormalize_blocked_t(x, block=8, iterations=2))(X)
    Q.block_until_ready()
    dt = time.perf_counter() - t0
    assert dt < 60, f"m=256 ortho compile+run took {dt:.1f}s"
    G = np.asarray(Q @ Q.T)
    np.testing.assert_allclose(G, np.eye(m), atol=2e-3)


@pytest.mark.parametrize("fmt", ["dia", "ell", "bsr"])
def test_spmm_t_matches_spmm(fmt):
    import scipy.sparse as sp

    from dune_eigensolver_tpu.sparse.formats import (
        bsr_from_scipy,
        dia_from_scipy,
        ell_from_scipy,
    )

    rng = np.random.default_rng(0)
    n, m = 96, 8
    S = sp.random(n, n, density=0.08, random_state=0, format="csr")
    S = S + sp.eye(n)
    if fmt == "dia":
        A = dia_from_scipy(sp.diags(
            [rng.standard_normal(n - 3), rng.standard_normal(n),
             rng.standard_normal(n - 3)], [-3, 0, 3]), dtype=np.float64)
    elif fmt == "ell":
        A = ell_from_scipy(S, dtype=np.float64)
    else:
        A = bsr_from_scipy(S, block=(4, 4), dtype=np.float64)
    X = jax.random.normal(jax.random.PRNGKey(5), (n, m), dtype=jnp.float64)
    Y1 = np.asarray(spmm(A, X))
    Y2 = np.asarray(spmm_t(A, X.T).T)
    np.testing.assert_allclose(Y1, Y2, rtol=1e-10, atol=1e-10)


def test_spmm_t_padded_dispatch():
    from dune_eigensolver_tpu.kernels.dia_spmm import PaddedLayout

    A = problems.laplacian_dirichlet_2d(16, dtype=np.float32)
    n = A.shape[0]
    Xt = jax.random.normal(jax.random.PRNGKey(6), (8, n), dtype=jnp.float32)
    L = PaddedLayout(n, 8, A.offsets)
    Ap = L.pad_operator(A)
    Yp = spmm_t(Ap, L.pad(Xt))  # interpret mode (tests/conftest.py)
    Yref = spmm(A, Xt.T).T
    np.testing.assert_allclose(
        np.asarray(L.unpad(Yp)), np.asarray(Yref), rtol=1e-5, atol=1e-5
    )


# --- spectral fallback for numerically rank-deficient blocks -----------------
# A nested-iteration seed (q0 from a coarser grid) produces search-basis
# blocks whose f32 Gram is rank-deficient below accumulation roundoff; the
# pure-Cholesky whitening NaN'd at n=10M no matter the relative eps floor.
# _whiten_apply cond-gates an eigh-based
# clipped whitening that fires only when the Cholesky comes out non-finite.


def test_ortho_rank_deficient_block_finite():
    X = jax.random.normal(jax.random.PRNGKey(7), (8, 64), dtype=jnp.float32)
    X = X.at[4:].set(X[:4])  # exact rank 4: singular Gram, chol -> NaN
    Q = orthonormalize_blocked_t(X, block=8, eps=0.0)
    Qh = np.asarray(Q)
    assert np.isfinite(Qh).all()
    # the healthy 4-dim span is orthonormalized; defective directions are
    # clipped to (near-)zero singular values, never NaN
    s = np.linalg.svd(Qh, compute_uv=False)
    np.testing.assert_allclose(s[:4], 1.0, atol=1e-3)


def test_b_ortho_rank_deficient_block_finite():
    X = jax.random.normal(jax.random.PRNGKey(8), (8, 64), dtype=jnp.float32)
    X = X.at[4:].set(2.0 * X[:4])
    Q, mon = b_orthonormalize_blocked_t(lambda V: V, X, block=8, eps=0.0)
    Qh = np.asarray(Q)
    assert np.isfinite(Qh).all()
    s = np.linalg.svd(Qh, compute_uv=False)
    np.testing.assert_allclose(s[:4], 1.0, atol=1e-3)
    # prefix-sweep variant (two blocks of 4): the second block is fully
    # dependent on the first -> its post-projection Gram is roundoff noise
    Q2, _ = b_orthonormalize_blocked_t(lambda V: V, X, block=4, eps=0.0)
    assert np.isfinite(np.asarray(Q2)).all()


def test_ortho_zero_block_stays_zero():
    X = jnp.zeros((8, 64), dtype=jnp.float32)
    Q = orthonormalize_blocked_t(X, block=8, eps=0.0)
    Qh = np.asarray(Q)
    assert np.isfinite(Qh).all()
    np.testing.assert_allclose(Qh, 0.0, atol=1e-20)


def test_ortho_healthy_path_unchanged():
    # a well-conditioned block must still go through plain CholeskyQR and
    # produce an orthonormal basis to f32 accuracy
    X = jax.random.normal(jax.random.PRNGKey(9), (16, 256), dtype=jnp.float32)
    Q = orthonormalize_blocked_t(X, block=8, eps=0.0, iterations=2)
    G = np.asarray(Q) @ np.asarray(Q).T
    np.testing.assert_allclose(G, np.eye(16), atol=5e-6)
