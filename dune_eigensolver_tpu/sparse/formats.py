"""Sparse matrix containers as JAX pytrees.

The reference stores operands as DUNE ISTL ``BCRSMatrix<FieldMatrix<double,br,bc>>``
(block compressed row storage) and streams them row-by-row inside hand-written
SIMD kernels (reference: dune/eigensolver/kernels_cpp.hh:596-657). Under
XLA the analogous containers must present *static shapes* and *vectorizable
access patterns*, so we use:

* ``DIAMatrix``  — diagonal storage. The right format for the stencil-type
  test operators of the reference driver (2D 5-point / 3D 7-point Laplacians,
  partition-of-unity mass matrices, src/dune-eigensolver.cc:98-156): SpMM
  becomes a handful of shifted fused multiply-adds with zero indexing
  irregularity. Offsets are *static* Python ints so XLA sees constant shifts.
* ``ELLMatrix``  — padded row storage (ELLPACK). General fallback for
  unstructured sparsity; SpMM is a row-gather + FMA.
* ``BSRMatrix``  — block-ELL: padded block-row storage with dense
  ``(br, bc)`` blocks, the equivalent of ISTL's BCRS with
  ``FieldMatrix<double,br,bc>`` blocks (elasticity-type operators).

All containers register as pytrees so they pass through ``jit``/``shard_map``
transparently; static metadata (shape, offsets, block size) lives in the
pytree structure.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )
    return cls


@dataclasses.dataclass(frozen=True)
class DIAMatrix:
    """Sparse matrix stored by diagonals.

    ``data[d, i]`` is the entry ``(i, i + offsets[d])``; entries whose column
    index falls outside ``[0, n)`` are stored as zero. ``offsets`` is a static
    tuple so every SpMM shift compiles to a constant-offset slice.
    """

    data: jax.Array  # (ndiag, n)
    offsets: Tuple[int, ...]  # static
    shape: Tuple[int, int]  # static

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        """Stored entries (incl. structural zeros inside the band)."""
        n = self.shape[0]
        return int(sum(n - abs(o) for o in self.offsets))

    @property
    def dtype(self):
        return self.data.dtype

    def diagonal(self) -> jax.Array:
        d = self.offsets.index(0)
        return self.data[d]

    def with_shifted_diagonal(self, shift) -> "DIAMatrix":
        """Return A + shift*I without mutating (the reference shifts in place,
        eigensolver.hh:59-66; we stay functional)."""
        d = self.offsets.index(0)
        data = self.data.at[d].add(jnp.asarray(shift, self.data.dtype))
        return DIAMatrix(data=data, offsets=self.offsets, shape=self.shape)

    def axpy(self, alpha, other: "DIAMatrix") -> "DIAMatrix":
        """self + alpha*other. Requires pattern(other) ⊆ pattern(self)
        (mirrors A.axpy(shift,B) precondition, eigensolver.hh:241-242)."""
        if not set(other.offsets) <= set(self.offsets):
            raise ValueError("axpy: other's diagonals must be a subset")
        data = self.data
        alpha = jnp.asarray(alpha, data.dtype)
        for d_o, off in enumerate(other.offsets):
            d_s = self.offsets.index(off)
            data = data.at[d_s].add(alpha * other.data[d_o])
        return DIAMatrix(data=data, offsets=self.offsets, shape=self.shape)

    def to_scipy(self):
        import scipy.sparse as sp

        # ours is row-indexed (data[d, i] = A[i, i+o]); scipy's DIA is
        # column-indexed (data[d, j] = A[j-o, j]) — shift accordingly.
        n = self.shape[0]
        ours = np.asarray(self.data)
        sdata = np.zeros_like(ours)
        for d, o in enumerate(self.offsets):
            if o >= 0:
                sdata[d, o:] = ours[d, : n - o] if o else ours[d]
            else:
                sdata[d, : n + o] = ours[d, -o:]
        return sp.dia_matrix(
            (sdata, np.asarray(self.offsets, dtype=np.int64)), shape=self.shape
        ).tocsr()


_register(DIAMatrix, ["data"], ["offsets", "shape"])


@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """ELLPACK: every row padded to ``k`` entries.

    Padding entries have ``cols == padded row's own index`` (an always-valid
    index) and ``data == 0`` so gathers stay in bounds and contribute nothing.
    """

    data: jax.Array  # (n, k)
    cols: jax.Array  # (n, k) int32
    shape: Tuple[int, int]  # static
    nnz: int  # static — true nonzeros before padding

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    def _diag_masks(self):
        n = self.shape[0]
        on_diag = self.cols == jnp.arange(n, dtype=self.cols.dtype)[:, None]
        # padding slots reuse the row's own column index, so restrict shifts
        # to the FIRST on-diagonal slot per row (real entries sort first)
        first = on_diag & (jnp.cumsum(on_diag, axis=1) == 1)
        return on_diag, first

    def diagonal(self) -> jax.Array:
        on_diag, _ = self._diag_masks()
        return jnp.sum(jnp.where(on_diag, self.data, 0), axis=1)

    def with_shifted_diagonal(self, shift) -> "ELLMatrix":
        """A + shift*I (functional; reference shifts in place,
        eigensolver.hh:59-66). Rows lacking a diagonal entry get one in their
        first padding slot."""
        _, first = self._diag_masks()
        data = self.data + jnp.asarray(shift, self.dtype) * first.astype(self.dtype)
        return ELLMatrix(data=data, cols=self.cols, shape=self.shape, nnz=self.nnz)

    def axpy(self, alpha, other) -> "ELLMatrix":
        """self + alpha*other (host-side setup op, like the reference's
        A.axpy(shift, B) before factorization, eigensolver.hh:241-242)."""
        S = self.to_scipy() + float(alpha) * other.to_scipy()
        return ell_from_scipy(S, dtype=self.dtype, k=self.k)

    def to_scipy(self):
        import scipy.sparse as sp

        n, _ = self.shape
        rows = np.repeat(np.arange(n), self.k)
        cols = np.asarray(self.cols).reshape(-1)
        vals = np.asarray(self.data).reshape(-1)
        return sp.csr_matrix((vals, (rows, cols)), shape=self.shape)


_register(ELLMatrix, ["data", "cols"], ["shape", "nnz"])


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Block-ELL storage: padded block rows of dense (br, bc) blocks.

    Equivalent of ISTL BCRS with FieldMatrix blocks. ``bcols`` is
    (nbr, k) int32 of block-column indices (padding: own block index, zero
    block), ``bdata`` is (nbr, k, br, bc).
    """

    bdata: jax.Array  # (nbr, k, br, bc)
    bcols: jax.Array  # (nbr, k)
    shape: Tuple[int, int]  # static, in scalar (unblocked) coordinates
    block: Tuple[int, int]  # static (br, bc)
    nnz: int  # static — scalar nonzeros

    @property
    def nbr(self) -> int:
        return self.bdata.shape[0]

    @property
    def dtype(self):
        return self.bdata.dtype

    def _diag_masks(self):
        on_diag = self.bcols == jnp.arange(self.nbr, dtype=self.bcols.dtype)[:, None]
        first = on_diag & (jnp.cumsum(on_diag, axis=1) == 1)
        return on_diag, first

    def diagonal(self) -> jax.Array:
        """Scalar diagonal of the blocked operator (requires br == bc)."""
        br, bc = self.block
        if br != bc:
            raise ValueError("diagonal: needs square blocks")
        on_diag, _ = self._diag_masks()
        dblocks = jnp.sum(
            jnp.where(on_diag[..., None, None], self.bdata, 0), axis=1
        )  # (nbr, br, br)
        return jax.vmap(jnp.diag)(dblocks).reshape(-1)

    def with_shifted_diagonal(self, shift) -> "BSRMatrix":
        br, bc = self.block
        if br != bc:
            raise ValueError("with_shifted_diagonal: needs square blocks")
        _, first = self._diag_masks()
        eye = jnp.eye(br, dtype=self.dtype)
        bdata = self.bdata + (
            jnp.asarray(shift, self.dtype)
            * first[..., None, None].astype(self.dtype)
            * eye
        )
        return BSRMatrix(
            bdata=bdata, bcols=self.bcols, shape=self.shape, block=self.block,
            nnz=self.nnz,
        )

    def axpy(self, alpha, other) -> "BSRMatrix":
        """self + alpha*other (host-side setup op)."""
        S = self.to_scipy() + float(alpha) * other.to_scipy()
        return bsr_from_scipy(S, block=self.block, dtype=self.dtype)

    def to_scipy(self):
        import scipy.sparse as sp

        br, bc = self.block
        nbr, k = self.bcols.shape
        indptr = np.arange(nbr + 1) * k
        indices = np.asarray(self.bcols).reshape(-1)
        data = np.asarray(self.bdata).reshape(-1, br, bc)
        return sp.bsr_matrix((data, indices, indptr), shape=self.shape).tocsr()


_register(BSRMatrix, ["bdata", "bcols"], ["shape", "block", "nnz"])


# ---------------------------------------------------------------------------
# Converters (host-side setup; numpy in, device arrays out)
# ---------------------------------------------------------------------------


def dia_from_scipy(A, dtype=None) -> DIAMatrix:
    """Convert any scipy sparse matrix to DIAMatrix (host-side setup)."""
    import scipy.sparse as sp

    A = sp.dia_matrix(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError("dia_from_scipy: matrix must be square")
    order = np.argsort(A.offsets)
    offsets = tuple(int(o) for o in A.offsets[order])
    n = A.shape[0]
    ndiag = len(offsets)
    data = np.zeros((ndiag, n), dtype=A.data.dtype)
    # scipy dia stores data[d, j] = entry at column j on diagonal offsets[d];
    # our convention indexes by row i (column = i + offset).
    for d, src in enumerate(order):
        o = offsets[d]
        sdata = A.data[src]
        if o >= 0:
            rows = np.arange(0, n - o)
            data[d, rows] = sdata[rows + o]
        else:
            rows = np.arange(-o, n)
            data[d, rows] = sdata[rows + o]
    if dtype is not None:
        data = data.astype(dtype)
    return DIAMatrix(data=jnp.asarray(data), offsets=offsets, shape=tuple(A.shape))


def ell_from_scipy(A, dtype=None, k=None) -> ELLMatrix:
    """Convert scipy sparse to ELL. ``k`` pads to at least that row width."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    A.sort_indices()
    n, m = A.shape
    row_nnz = np.diff(A.indptr)
    kmax = int(row_nnz.max()) if n else 0
    if k is not None:
        kmax = max(kmax, k)
    cols = np.tile(np.minimum(np.arange(n), m - 1)[:, None], (1, kmax)).astype(
        np.int32
    )
    data = np.zeros((n, kmax), dtype=A.data.dtype)
    # vectorized fill: position within row for each nonzero
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], row_nnz)
    rows = np.repeat(np.arange(n), row_nnz)
    cols[rows, pos] = A.indices
    data[rows, pos] = A.data
    if dtype is not None:
        data = data.astype(dtype)
    return ELLMatrix(
        data=jnp.asarray(data),
        cols=jnp.asarray(cols),
        shape=(n, m),
        nnz=int(A.nnz),
    )


def bsr_from_scipy(A, block: Tuple[int, int], dtype=None) -> BSRMatrix:
    """Convert scipy sparse to block-ELL with dense (br, bc) blocks."""
    import scipy.sparse as sp

    br, bc = block
    A = sp.bsr_matrix(sp.csr_matrix(A), blocksize=(br, bc))
    A.sort_indices()
    nbr = A.shape[0] // br
    row_nnz = np.diff(A.indptr)
    kmax = int(row_nnz.max()) if nbr else 0
    nbc = A.shape[1] // bc
    bcols = np.tile(np.minimum(np.arange(nbr), nbc - 1)[:, None], (1, kmax)).astype(
        np.int32
    )
    bdata = np.zeros((nbr, kmax, br, bc), dtype=A.data.dtype)
    pos_all = np.arange(A.indices.shape[0]) - np.repeat(A.indptr[:-1], row_nnz)
    rows_all = np.repeat(np.arange(nbr), row_nnz)
    bcols[rows_all, pos_all] = A.indices
    bdata[rows_all, pos_all] = A.data
    if dtype is not None:
        bdata = bdata.astype(dtype)
    return BSRMatrix(
        bdata=jnp.asarray(bdata),
        bcols=jnp.asarray(bcols),
        shape=tuple(A.shape),
        block=(br, bc),
        nnz=int(sp.csr_matrix(A).nnz),
    )
