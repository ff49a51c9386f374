"""Test-problem generators.

Re-implements the *math* of the reference driver's problem builders
(src/dune-eigensolver.cc:98-156): 2D 5-point Laplacian (ISTL
``setupLaplacian``: 4 on the diagonal, -1 for grid neighbors), the Neumann
variant (diagonal := |sum of off-diagonals|), the GenEO-style B matrix
(Laplacian masked by a partition-of-unity that vanishes within ``overlap`` of
the boundary), and the identity on the Laplacian pattern. Adds the 3D 7-point
Laplacian required by the north-star configs (BASELINE.md).

Matrices are built directly in DIA form with numpy (vectorized, no
scipy intermediates) so 10M-dof 3D problems assemble in milliseconds.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from dune_eigensolver_tpu.sparse.formats import DIAMatrix


def _dia(data: np.ndarray, offsets, n, dtype) -> DIAMatrix:
    return DIAMatrix(
        data=jnp.asarray(data.astype(dtype)),
        offsets=tuple(int(o) for o in offsets),
        shape=(n, n),
    )


def _laplacian_dirichlet_2d_np(N: int):
    """Assembly stays in numpy; jnp conversion happens only at the public
    boundary (_dia) — composing builders must never round-trip through the
    device (a device->host fetch can stall under forced multi-device CPU)."""
    n = N * N
    offsets = (-N, -1, 0, 1, N)
    data = np.zeros((5, n))
    i = np.arange(n)
    data[0] = np.where(i >= N, -1.0, 0.0)  # -N
    data[1] = np.where(i % N != 0, -1.0, 0.0)  # -1 (not across grid rows)
    data[2] = 4.0
    data[3] = np.where(i % N != N - 1, -1.0, 0.0)  # +1
    data[4] = np.where(i < n - N, -1.0, 0.0)  # +N
    return data, offsets, n


def laplacian_dirichlet_2d(N: int, dtype=np.float64) -> DIAMatrix:
    """2D 5-point Laplacian on an N x N grid, lexicographic ordering.

    Reference: get_laplacian_dirichlet (src/dune-eigensolver.cc:98-103),
    which delegates to dune-istl's setupLaplacian (4 on diag, -1 neighbors).
    """
    data, offsets, n = _laplacian_dirichlet_2d_np(N)
    return _dia(data, offsets, n, dtype)


def laplacian_neumann_2d(N: int, dtype=np.float64) -> DIAMatrix:
    """Neumann-type variant: diagonal := |sum of off-diagonal entries|.

    Reference: get_laplacian_neumann (src/dune-eigensolver.cc:105-121).
    """
    data, offsets, n = _laplacian_dirichlet_2d_np(N)
    d0 = offsets.index(0)
    off_sum = data.sum(axis=0) - data[d0]
    data[d0] = np.abs(off_sum)
    return _dia(data, offsets, n, dtype)


def partition_of_unity_2d(N: int, overlap: int) -> np.ndarray:
    """pu[k] = 0 within ``overlap`` of the grid boundary, else 1.

    Reference: src/dune-eigensolver.cc:129-138.
    """
    i = np.arange(N * N) // N
    j = np.arange(N * N) % N
    near = (
        (i < overlap)
        | (i > N - 1 - overlap)
        | (j < overlap)
        | (j > N - 1 - overlap)
    )
    return np.where(near, 0.0, 1.0)


def laplacian_b_2d(N: int, overlap: int, dtype=np.float64) -> DIAMatrix:
    """GenEO-style B: Laplacian entries masked by the partition of unity,
    B_ij = A_ij * pu_i * pu_j.

    Reference: get_laplacian_B (src/dune-eigensolver.cc:124-143).
    """
    data, offsets, n = _laplacian_dirichlet_2d_np(N)
    pu = partition_of_unity_2d(N, overlap)
    i = np.arange(n)
    for d, off in enumerate(offsets):
        col = i + off
        pu_col = np.where((col >= 0) & (col < n), pu[np.clip(col, 0, n - 1)], 0.0)
        data[d] = data[d] * pu * pu_col
    return _dia(data, offsets, n, dtype)


def identity_on_pattern(A: DIAMatrix, dtype=None) -> DIAMatrix:
    """Identity matrix stored on A's diagonal pattern.

    Reference: get_identity (src/dune-eigensolver.cc:145-156).
    """
    dtype = dtype or A.data.dtype
    n = A.shape[0]
    data = np.zeros((len(A.offsets), n))
    data[A.offsets.index(0)] = 1.0
    return _dia(data, A.offsets, n, dtype)


def laplacian_islands_2d(N: int, islands: int, dtype=np.float64) -> DIAMatrix:
    """``islands`` decoupled N x N Dirichlet Laplacians in one operator.

    The matrix the reference's disabled SpMM benchmark calls for ("islands
    matrix", src/dune-eigensolver.cc:421-425): constant per-partition work
    with no cross-partition coupling — ideal for weak-scaling measurements.
    """
    data, offsets, n = _laplacian_dirichlet_2d_np(N)
    tiled = np.tile(data, (1, islands))
    return _dia(tiled, offsets, n * islands, dtype)


def _laplacian_3d_device(N: int, dtype) -> jnp.ndarray:
    """Device-side assembly of the 3D diagonals: at 10M dof the (7, n) data
    is ~280 MB; the formulas below run as one jit with nothing shipped
    from the host."""
    import jax
    from functools import partial

    @partial(jax.jit, static_argnums=(0, 1))
    def build(N, dtype):
        n = N * N * N
        i = jnp.arange(n, dtype=jnp.int32)
        one = jnp.asarray(-1.0, dtype)
        zero = jnp.asarray(0.0, dtype)
        rows = [
            jnp.where(i >= N * N, one, zero),
            jnp.where((i // N) % N != 0, one, zero),
            jnp.where(i % N != 0, one, zero),
            jnp.full((n,), 6.0, dtype),
            jnp.where(i % N != N - 1, one, zero),
            jnp.where((i // N) % N != N - 1, one, zero),
            jnp.where(i < n - N * N, one, zero),
        ]
        return jnp.stack(rows)

    return build(N, jnp.dtype(dtype))


def laplacian_dirichlet_3d(N: int, dtype=np.float32) -> DIAMatrix:
    """3D 7-point Laplacian on an N^3 grid (north-star problem, BASELINE.md).
    Assembled on device (see _laplacian_3d_device)."""
    n = N * N * N
    offsets = (-N * N, -N, -1, 0, 1, N, N * N)
    return DIAMatrix(
        data=_laplacian_3d_device(N, dtype), offsets=offsets, shape=(n, n)
    )


def laplacian_dirichlet_rect(Nx: int, Ny: int, dtype=np.float64) -> DIAMatrix:
    """2D 5-point Laplacian on an Nx x Ny grid (row-major over y then x):
    the CONNECTED weak-scaling operand — row-partitioning a strip of rows
    cuts real -1 couplings, so halo exchanges carry live data (unlike the
    islands matrix, whose exchanged rows multiply zeros)."""
    n = Nx * Ny
    offsets = (-Nx, -1, 0, 1, Nx)
    data = np.zeros((5, n))
    i = np.arange(n)
    data[0] = np.where(i >= Nx, -1.0, 0.0)
    data[1] = np.where(i % Nx != 0, -1.0, 0.0)
    data[2] = 4.0
    data[3] = np.where(i % Nx != Nx - 1, -1.0, 0.0)
    data[4] = np.where(i < n - Nx, -1.0, 0.0)
    return _dia(data, offsets, n, dtype)


# ---------------------------------------------------------------------------
# Non-stencil operators (block / unstructured sparsity)
# ---------------------------------------------------------------------------


def elasticity_2d(
    N: int,
    E: float = 1.0,
    nu: float = 0.3,
    dtype=np.float64,
    lumped_mass: bool = True,
):
    """2D plane-stress linear elasticity on an N x N Q1 quad mesh, clamped
    boundary: the elasticity-type operator class the reference stores as
    ``BCRSMatrix<FieldMatrix<double,2,2>>`` (block pattern of
    umfpacktools.hh:57-95). Returns (A, B) as block-ELL ``BSRMatrix`` with
    (2, 2) blocks: A = stiffness, B = (lumped) mass.

    Assembled host-side with 2x2 Gauss quadrature on the canonical bilinear
    element; boundary nodes are eliminated (interior (N-1)^2 nodes, two dofs
    each, lexicographic) so the spectrum is that of the clamped plate.
    """
    import scipy.sparse as sp

    from dune_eigensolver_tpu.sparse.formats import bsr_from_scipy

    if N < 2:
        raise ValueError("elasticity_2d: need N >= 2")
    h = 1.0 / N
    gp = (-1.0 / np.sqrt(3.0), 1.0 / np.sqrt(3.0))
    D = (E / (1.0 - nu * nu)) * np.array(
        [[1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, (1.0 - nu) / 2.0]]
    )
    Ke = np.zeros((8, 8))
    Me = np.zeros((8, 8))
    J = h / 2.0
    for xi in gp:
        for eta in gp:
            dN = 0.25 * np.array(
                [
                    [-(1 - eta), (1 - eta), (1 + eta), -(1 + eta)],
                    [-(1 - xi), -(1 + xi), (1 + xi), (1 - xi)],
                ]
            )
            Nsh = 0.25 * np.array(
                [(1 - xi) * (1 - eta), (1 + xi) * (1 - eta),
                 (1 + xi) * (1 + eta), (1 - xi) * (1 + eta)]
            )
            dNxy = dN / J
            Bm = np.zeros((3, 8))
            Bm[0, 0::2] = dNxy[0]
            Bm[1, 1::2] = dNxy[1]
            Bm[2, 0::2] = dNxy[1]
            Bm[2, 1::2] = dNxy[0]
            Ke += (Bm.T @ D @ Bm) * (J * J)
            Nv = np.zeros((2, 8))
            Nv[0, 0::2] = Nsh
            Nv[1, 1::2] = Nsh
            Me += (Nv.T @ Nv) * (J * J)

    nn = N + 1  # nodes per side
    node = lambda i, j: i * nn + j  # noqa: E731
    rows, cols, vK, vM = [], [], [], []
    for ei in range(N):
        for ej in range(N):
            nodes = [
                node(ei, ej), node(ei, ej + 1),
                node(ei + 1, ej + 1), node(ei + 1, ej),
            ]
            dofs = np.array([2 * q + c for q in nodes for c in (0, 1)])
            rows.append(np.repeat(dofs, 8))
            cols.append(np.tile(dofs, 8))
            vK.append(Ke.ravel())
            vM.append(Me.ravel())
    ndof = 2 * nn * nn
    K = sp.coo_matrix(
        (np.concatenate(vK), (np.concatenate(rows), np.concatenate(cols))),
        shape=(ndof, ndof),
    ).tocsr()
    M = sp.coo_matrix(
        (np.concatenate(vM), (np.concatenate(rows), np.concatenate(cols))),
        shape=(ndof, ndof),
    ).tocsr()
    ij = np.arange(nn)
    interior = np.array(
        [node(i, j) for i in ij[1:-1] for j in ij[1:-1]], dtype=np.int64
    )
    keep = np.stack([2 * interior, 2 * interior + 1], axis=1).ravel()
    K = K[keep][:, keep].tocsr()
    M = M[keep][:, keep].tocsr()
    if lumped_mass:
        M = sp.diags(np.asarray(M.sum(axis=1)).ravel()).tocsr()
    A = bsr_from_scipy(K, block=(2, 2), dtype=dtype)
    B = bsr_from_scipy(M, block=(2, 2), dtype=dtype)
    return A, B


def unstructured_laplacian(
    n: int, extra_edges: int = 0, seed: int = 0, dtype=np.float64, fmt: str = "ell"
):
    """Graph Laplacian (+I) of a random-permuted 1D chain with ``extra_edges``
    random long-range couplings — an UNSTRUCTURED pattern no DIA container
    can hold (the operator class the reference handles through arbitrary
    CSR, kernels_cpp.hh:626-657). Returns an ELLMatrix (fmt='ell') or a
    scipy CSR (fmt='scipy'); RCM-reorder before a banded direct solve or
    the sharded drivers (sparse.reorder.rcm_pencil)."""
    import scipy.sparse as sp

    from dune_eigensolver_tpu.sparse.formats import ell_from_scipy

    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    src = perm[:-1]
    dst = perm[1:]
    if extra_edges:
        e1 = rng.integers(0, n, extra_edges)
        e2 = rng.integers(0, n, extra_edges)
        mask = e1 != e2
        src = np.concatenate([src, e1[mask]])
        dst = np.concatenate([dst, e2[mask]])
    W = sp.coo_matrix(
        (np.ones(len(src)), (src, dst)), shape=(n, n)
    )
    W = W + W.T
    W.data[:] = 1.0
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W + sp.eye(n)
    L = sp.csr_matrix(L)
    if fmt == "scipy":
        return L
    return ell_from_scipy(L, dtype=dtype)
