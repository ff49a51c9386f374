"""General-sparsity SpMM (XLA ELL / block-ELL gathers), the per-shard ELL
plan, and the non-stencil end-to-end solves they carry.

The reference's kernels stream arbitrary CSR/BCRS patterns
(kernels_cpp.hh:626-657, blocks umfpacktools.hh:57-95); these tests pin the
XLA formulations against scipy in float64 across the operand classes the
solvers see: 2x2 and 3x3 blocks, wide multivectors, bf16 inputs, patterns
no reordering can band, and empty rows.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from dune_eigensolver_tpu.sparse import problems
from dune_eigensolver_tpu.sparse.formats import (
    bsr_from_scipy,
    dia_from_scipy,
    ell_from_scipy,
)
from dune_eigensolver_tpu.sparse.reorder import rcm_pencil, unpermute_vectors
from dune_eigensolver_tpu.sparse.spmm import bsr_spmm_t, ell_spmm_t

TOL = 2e-3


def _random_sym_csr(n, avg_nnz, seed):
    """Random sparse SPD (weighted-graph-Laplacian-like: -|w| off-diagonal,
    diagonally dominant), RCM-ordered — the solver/oracle smallest-set
    semantics agree only for definite operators."""
    S = sp.random(n, n, density=avg_nnz / n, random_state=seed, format="csr")
    S = S + S.T
    S.data = -np.abs(S.data)
    S = S - sp.diags(S.diagonal())
    S = S + sp.diags(np.asarray(-S.sum(axis=1)).ravel() + 0.5)
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    perm = reverse_cuthill_mckee(sp.csr_matrix(S), symmetric_mode=True)
    return sp.csr_matrix(S)[perm][:, perm]


def _blocked(nb, b, seed, rng):
    Sb = _random_sym_csr(nb, 5, seed=seed)
    blockmat = rng.normal(size=(b, b))
    return sp.csr_matrix(sp.kron(Sb, blockmat + blockmat.T + 4 * np.eye(b)))


def _ref_t(S, Xt):
    return (S.astype(np.float64) @ np.asarray(Xt, np.float64).T).T


def _rel(Y, ref):
    return np.abs(np.asarray(Y, np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("m", [8, 16, 32, 64, 128])
def test_ell_spmm_t_matches_scipy(rng, m):
    S = _random_sym_csr(1500, 7, seed=1)
    A = ell_from_scipy(S, dtype=np.float32)
    Xt = jnp.asarray(rng.normal(size=(m, A.shape[0])).astype(np.float32))
    assert _rel(ell_spmm_t(A, Xt), _ref_t(S, Xt)) < 1e-5


@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("block", [(2, 2), (3, 3)])
def test_bsr_spmm_t_matches_scipy(rng, block, m):
    S = _blocked(400, block[0], 1, rng)
    A = bsr_from_scipy(S, block=block, dtype=np.float32)
    Xt = jnp.asarray(rng.normal(size=(m, A.shape[0])).astype(np.float32))
    assert _rel(bsr_spmm_t(A, Xt), _ref_t(S, Xt)) < 1e-5


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_general_spmm_bf16_inputs(rng, fmt):
    # bf16 operands: the result keeps bf16 storage; compare against the
    # float64 product of the same bf16-rounded inputs
    S = _blocked(300, 2, 4, rng)
    if fmt == "ell":
        A = ell_from_scipy(S, dtype=jnp.bfloat16)
        fn = ell_spmm_t
    else:
        A = bsr_from_scipy(S, block=(2, 2), dtype=jnp.bfloat16)
        fn = bsr_spmm_t
    S16 = S.copy()
    S16.data = np.asarray(jnp.asarray(S.data, jnp.bfloat16), np.float64)
    Xt = jnp.asarray(rng.normal(size=(8, S.shape[0]))).astype(jnp.bfloat16)
    Y = fn(A, Xt)
    assert Y.dtype == jnp.bfloat16
    ref = _ref_t(S16.astype(np.float64), np.asarray(Xt, np.float32))
    assert _rel(np.asarray(Y, np.float32), ref) < 2e-2


def test_ell_unbandable_random_pattern(rng):
    # uniform random long-range pattern: no ordering confines its band; the
    # gather formulation is exact regardless
    n = 5000
    g = np.random.default_rng(9)
    nnz = 4 * n
    S = sp.coo_matrix(
        (g.normal(size=nnz), (g.integers(0, n, nnz), g.integers(0, n, nnz))),
        shape=(n, n),
    ).tocsr()
    S = (S + S.T + sp.eye(n)).tocsr()
    A = ell_from_scipy(S, dtype=np.float32)
    Xt = jnp.asarray(g.normal(size=(8, n)).astype(np.float32))
    assert _rel(ell_spmm_t(A, Xt), _ref_t(S, Xt)) < 1e-5


def test_ell_empty_rows(rng):
    # rows with no entries at all: their padding slots carry zeros
    S = _random_sym_csr(600, 5, seed=3).tolil()
    for r in (0, 17, 599):
        S[r, :] = 0
    S = S.tocsr()
    S.eliminate_zeros()
    A = ell_from_scipy(S, dtype=np.float32)
    Xt = jnp.asarray(rng.normal(size=(16, 600)).astype(np.float32))
    Y = np.asarray(ell_spmm_t(A, Xt))
    assert np.all(Y[:, [0, 17, 599]] == 0.0)
    assert _rel(Y, _ref_t(S, Xt)) < 1e-5


def test_bsr_empty_block_rows(rng):
    S = _blocked(200, 2, 5, rng).tolil()
    S[10:12, :] = 0  # block row 5 empty
    S = S.tocsr()
    S.eliminate_zeros()
    A = bsr_from_scipy(S, block=(2, 2), dtype=np.float32)
    Xt = jnp.asarray(rng.normal(size=(8, S.shape[0])).astype(np.float32))
    Y = np.asarray(bsr_spmm_t(A, Xt))
    assert np.all(Y[:, 10:12] == 0.0)
    assert _rel(Y, _ref_t(S, Xt)) < 1e-5


@pytest.mark.parametrize("kind", ["ell", "bsr", "dia", "padded"])
def test_internal_width(kind):
    # Chebyshev sizes its power-iteration block from the internal width:
    # n for every plain container, the guarded width for PaddedDIA
    from dune_eigensolver_tpu.factorize.chebyshev import _internal_width
    from dune_eigensolver_tpu.kernels.dia_spmm import PaddedLayout

    A = problems.laplacian_dirichlet_2d(16, dtype=np.float32)
    n = A.shape[0]
    if kind == "ell":
        op = ell_from_scipy(A.to_scipy(), dtype=np.float32)
        assert op.k == 5  # the row length is not the width
    elif kind == "bsr":
        op = bsr_from_scipy(A.to_scipy(), block=(2, 2), dtype=np.float32)
    elif kind == "dia":
        op = A
    else:
        L = PaddedLayout(n, 8, A.offsets)
        op = L.pad_operator(A)
        assert _internal_width(op) == L.width
        return
    assert _internal_width(op) == n


def test_chebyshev_inverse_on_ell():
    # the Chebyshev engine on a plain ELL operand (the general path on the
    # GPU): its power iteration must run at width n, not the row length
    from dune_eigensolver_tpu.factorize import chebyshev_inverse_factory
    from dune_eigensolver_tpu.solvers.standard import normalize_inverse

    A = problems.laplacian_dirichlet_2d(16, dtype=np.float64)
    Ae = ell_from_scipy(A.with_shifted_diagonal(0.5).to_scipy(), dtype=np.float64)
    aux, fn = normalize_inverse(chebyshev_inverse_factory()(Ae))
    Xt = jax.random.normal(jax.random.PRNGKey(0), (8, A.shape[0]), jnp.float64)
    Y = fn(aux, Xt)
    assert Y.shape == Xt.shape and bool(jnp.all(jnp.isfinite(Y)))
    # an approximate inverse: A Y is close to X
    R = ell_spmm_t(Ae, Y) - Xt
    assert float(jnp.linalg.norm(R) / jnp.linalg.norm(Xt)) < 0.5


def test_generalized_inverse_elasticity_bsr_vs_oracle():
    # flagship non-stencil end-to-end: clamped-plate elasticity pencil,
    # XLA BSR SpMM + RCM-banded direct inverse, vs the scipy oracle
    from dune_eigensolver_tpu.oracle import smallest_generalized
    from dune_eigensolver_tpu.solvers import generalized_inverse

    A, B = problems.elasticity_2d(10, dtype=np.float64)
    res = generalized_inverse(A, B, nev=4, tol=1e-8, maxiter=300, shift=1e-3)
    ref, _ = smallest_generalized(A, B, nev=4, sigma=-1e-3)
    got = np.asarray(res.eigenvalues)[:4]
    assert np.abs(got - ref).max() / np.abs(ref).max() < TOL


def test_lobpcg_unstructured_ell_vs_oracle():
    from dune_eigensolver_tpu.factorize import cg_inverse_factory
    from dune_eigensolver_tpu.oracle import smallest_standard
    from dune_eigensolver_tpu.solvers import lobpcg_generalized

    n = 800
    S = problems.unstructured_laplacian(n, extra_edges=40, seed=5, fmt="scipy")
    A, _, perm = rcm_pencil(S, dtype=np.float64)
    B = ell_from_scipy(sp.eye(n), dtype=np.float64)
    res = lobpcg_generalized(
        A, B, nev=4, tol=1e-9, maxiter=300, shift=0.0,
        precond=cg_inverse_factory(rtol=1e-2, maxiter=25),
    )
    ref, refv = smallest_standard(S, nev=4, sigma=-1e-3)
    got = np.asarray(res.eigenvalues)[:4]
    assert np.abs(got - ref).max() < TOL
    # eigenvectors transform back with the permutation
    V = unpermute_vectors(np.asarray(res.eigenvectors)[:, :1], perm)
    r = S @ V[:, 0] - got[0] * V[:, 0]
    assert np.linalg.norm(r) / np.linalg.norm(V[:, 0]) < 5e-3


def test_standard_inverse_ell():
    # standard shift-invert on an ELL operand: XLA ELL SpMM + RCM-banded
    # factorization (B = None path)
    from dune_eigensolver_tpu.oracle import smallest_standard
    from dune_eigensolver_tpu.solvers import standard_inverse

    S = _random_sym_csr(700, 6, seed=7)
    A = ell_from_scipy(S, dtype=np.float64)
    res = standard_inverse(A, nev=4, tol=1e-9, maxiter=300, shift=1e-3)
    ref, _ = smallest_standard(S, nev=4, sigma=-1e-3)
    got = np.asarray(res.eigenvalues)[:4]
    assert np.abs(got - ref).max() / np.abs(ref).max() < TOL


def test_mixed_ell_dia_pencil_stays_plain():
    # a general A with a DIA mass matrix: the engine keeps both operands
    # plain (no guarded layout for non-DIA pairs) and the SpMMs agree
    from dune_eigensolver_tpu.solvers.engine import make_engine

    S = _random_sym_csr(600, 5, seed=3)
    Ae = ell_from_scipy(S, dtype=np.float32)
    Bd = dia_from_scipy(sp.eye(600), dtype=np.float32)
    A_int, B_int, layout, spec = make_engine(Ae, Bd, m=8, force_padded=True)
    assert layout is None and not spec.padded
    assert A_int is Ae and B_int is Bd


@pytest.mark.parametrize("P_shards", [1, 2, 3, 8])
def test_shard_plan_overlap_equals_serialized(P_shards):
    # the overlapped SpMM (local-only ELL + dense boundary blocks) equals
    # the serialized one (exchange, then ELL on the extended window) and
    # the global product, including pad rows when n % P != 0
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dune_eigensolver_tpu.dist import make_mesh, windowed_shard_plan
    from dune_eigensolver_tpu.dist.mesh import ROW_AXIS
    from dune_eigensolver_tpu.dist.windowed import (
        _plan_arrays,
        _plan_specs,
        _shard_bnd,
        _shard_container,
        windowed_spmm_halo_t,
    )

    n = 1001
    g = np.random.default_rng(11)
    r = g.integers(0, n, 3 * n)
    c = np.clip(r + g.integers(-60, 61, 3 * n), 0, n - 1)  # bandwidth 60
    S = sp.coo_matrix((g.normal(size=3 * n), (r, c)), shape=(n, n)).tocsr()
    S = (S + S.T + 4 * sp.eye(n)).tocsr()
    plan = windowed_shard_plan(S, P_shards)
    assert plan.n % P_shards == 0 and plan.rows == n
    assert plan.n - n == (-n) % P_shards
    mesh = make_mesh(P_shards)
    Xt = np.zeros((8, plan.n), np.float32)
    Xt[:, :n] = np.random.default_rng(0).normal(size=(8, n))
    Xsh = jax.device_put(jnp.asarray(Xt), NamedSharding(mesh, P(None, ROW_AXIS)))
    outs = []
    for overlap in (True, False):
        def local(x, *arrs, _o=overlap):
            op = _shard_container(plan, arrs)
            bnd = _shard_bnd(plan, arrs) if _o else None
            return windowed_spmm_halo_t(plan, op, x, axis=ROW_AXIS, bnd=bnd)

        fn = jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(None, ROW_AXIS),) + _plan_specs(ROW_AXIS),
            out_specs=P(None, ROW_AXIS), check_vma=False,
        ))
        outs.append(np.asarray(fn(Xsh, *_plan_arrays(plan))))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    assert _rel(outs[0][:, :n], _ref_t(S, Xt[:, :n])) < 1e-5
    # pad lanes stay exactly zero
    assert np.all(outs[0][:, n:] == 0.0)
