"""Host-side sparse LU factorization externalized to device arrays, plus a
level-scheduled multi-RHS triangular solve that runs on the device.

Equivalent of the reference's UMFPACK bridge + trisolve kernel:

* ``UMFPackFactorizedMatrix`` (umfpacktools.hh:16-220) converts the operand
  to flat CSC, factorizes with ``umfpack_dl_*`` and *externalizes* the
  factorization into raw arrays (L CSR, U CSC, row/col permutations P/Q, row
  scaling Rs). Here SuperLU (scipy.sparse.linalg.splu) plays UMFPACK's role
  at setup and the factors are externalized into *chunk-scheduled* device
  arrays.
* ``matmul_inverse_tallskinny_blocked`` (kernels_cpp.hh:660-755) then solves
  scale -> P-permute -> L forward (row-sequential) -> U backward
  (column-sequential) -> Q-permute for 8 RHS at a time. The row-by-row
  dependence chain does not map to a wide-vector device (SURVEY.md §7), so
  rows are grouped
  into dependency *levels* on the host; each level is one data-parallel
  gather + FMA + scatter on device, and ``lax.fori_loop`` walks the levels.

Solve convention (verified against scipy): with Equil off,
``L @ U = A[pr_inv][:, pc_inv]``, so ``A^-1 b = w[pc]`` where
``L z = b[pr_inv]`` and ``U w = z``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


# ---------------------------------------------------------------------------
# Host-side scheduling
# ---------------------------------------------------------------------------


def _levels_from_csr(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Dependency level of each row of a (strict) triangular CSR matrix:
    lev[i] = 1 + max(lev[j] for j in row i's off-diagonal entries)."""
    try:
        from dune_eigensolver_tpu.utils import native

        if native.available():
            return native.levels_from_csr(indptr, indices)
    except ImportError:
        pass
    n = len(indptr) - 1
    lev = np.zeros(n, dtype=np.int32)
    for i in range(n):
        deps = indices[indptr[i] : indptr[i + 1]]
        if deps.size:
            lev[i] = lev[deps].max() + 1
    return lev


def _chunk_schedule(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    n: int,
    chunk: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Build fixed-size row chunks that respect dependency levels.

    Returns (rows, cols, vals, kmax): rows (nchunk, chunk) int32 with pad=n;
    cols/vals (nchunk, chunk, kmax) with pad col=n, pad val=0.
    """
    try:
        from dune_eigensolver_tpu.utils import native

        sched = native.chunk_schedule(indptr, indices, data, n, chunk)
        if sched is not None:
            rows, cols, vals, kmax, _ = sched
            return rows, cols, vals, kmax
    except ImportError:
        pass
    lev = _levels_from_csr(indptr, indices)
    order = np.argsort(lev, kind="stable")
    lev_sorted = lev[order]
    # chunk boundaries: never split across a level boundary
    boundaries = [0]
    start = 0
    for i in range(1, n + 1):
        if i == n or lev_sorted[i] != lev_sorted[start] or i - start == chunk:
            boundaries.append(i)
            start = i
    nchunk = len(boundaries) - 1

    row_nnz = np.diff(indptr)
    kmax = int(row_nnz.max()) if n else 0
    kmax = max(kmax, 1)

    rows = np.full((nchunk, chunk), n, dtype=np.int32)
    cols = np.full((nchunk, chunk, kmax), n, dtype=np.int32)
    vals = np.zeros((nchunk, chunk, kmax), dtype=data.dtype)
    for c in range(nchunk):
        lo, hi = boundaries[c], boundaries[c + 1]
        rs = order[lo:hi]
        rows[c, : hi - lo] = rs
        for k, r in enumerate(rs):
            s, e = indptr[r], indptr[r + 1]
            cols[c, k, : e - s] = indices[s:e]
            vals[c, k, : e - s] = data[s:e]
    return rows, cols, vals, kmax


@dataclasses.dataclass(frozen=True)
class _TriFactor:
    rows: jax.Array  # (nchunk, C) int32, pad = n
    cols: jax.Array  # (nchunk, C, kmax) int32, pad = n
    vals: jax.Array  # (nchunk, C, kmax)
    nchunk: int  # static


jax.tree_util.register_dataclass(
    _TriFactor, data_fields=["rows", "cols", "vals"], meta_fields=["nchunk"]
)


@dataclasses.dataclass(frozen=True)
class FactorizedMatrix:
    """Externalized LU factorization resident on device.

    Mirrors the members of UMFPackFactorizedMatrix (umfpacktools.hh:26-44):
    L (unit lower, here chunk-scheduled), U (upper, chunk-scheduled),
    row/col permutations, diag(U)^-1, and the externalized row scaling
    ``rs`` (UMFPACK's Rs with do_recip=True semantics: the factors hold
    diag(rs) A and the solve multiplies the RHS by rs first)."""

    L: _TriFactor
    U: _TriFactor
    dinv: jax.Array  # (n,) 1/diag(U)
    pr_inv: jax.Array  # (n,) int32: y = b[pr_inv]
    pc: jax.Array  # (n,) int32: x = w[pc]
    rs: Optional[jax.Array]  # (n,) row scaling Rs (None = identity)
    n: int  # static
    stats: tuple  # static: (nnz_L, nnz_U, nlev_L, nlev_U) for reporting


jax.tree_util.register_dataclass(
    FactorizedMatrix,
    data_fields=["L", "U", "dinv", "pr_inv", "pc", "rs"],
    meta_fields=["n", "stats"],
)


def factorize(
    A,
    chunk: int = 512,
    permc_spec: str = "MMD_AT_PLUS_A",
    symmetric: bool = True,
    verbose: int = 0,
    dtype=None,
    equilibrate: bool = True,
) -> FactorizedMatrix:
    """Factorize a sparse operand on the host and externalize to device.

    ``A``: a DIA/ELL/BSR container or scipy sparse matrix. Setup runs on CPU
    (like the reference's UMFPACK call); the returned factors live on device
    and the solve is jittable.

    ``equilibrate``: row-scale before factorizing, UMFPACK-style
    (``Rs``/``do_recip``, umfpacktools.hh:170-186): Rs[i] = 1/sum|A[i,:]|,
    the factors hold Rs*A, and the solve applies Rs to the right-hand side
    first (the fused scale step of kernels_cpp.hh:682-705). scipy's SuperLU
    wrapper does not externalize its own equilibration arrays, so SuperLU
    runs with Equil off and the scaling is OURS — same semantics, and it
    keeps f32-externalized factors accurate on ill-scaled operators."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu

    if hasattr(A, "to_scipy"):
        dtype = dtype or A.data.dtype if hasattr(A, "data") else dtype
        A = A.to_scipy()
    A = sp.csc_matrix(A.astype(np.float64))
    n = A.shape[0]
    rs = None
    if equilibrate:
        rowsum = np.asarray(abs(A).sum(axis=1)).ravel()
        if np.any(rowsum == 0.0):
            raise ZeroDivisionError("factorize: exactly zero row")
        rs = 1.0 / rowsum
        A = sp.diags(rs) @ A
        A = sp.csc_matrix(A)
    lu = splu(
        A,
        permc_spec=permc_spec,
        options=dict(Equil=False, SymmetricMode=bool(symmetric)),
    )
    # singularity check mirrors umfpacktools.hh:147-164 (nz_udiag < n)
    udiag = lu.U.diagonal()
    if np.any(udiag == 0.0):
        raise ZeroDivisionError("factorize: matrix is singular (zero U diagonal)")

    Lcsr = sp.csr_matrix(lu.L)
    Lstrict = sp.tril(Lcsr, k=-1, format="csr")
    Ucsr = sp.csr_matrix(lu.U)
    Ustrict = sp.triu(Ucsr, k=1, format="csr")

    np_dtype = np.dtype(dtype) if dtype is not None else np.float32
    rowsL, colsL, valsL, _ = _chunk_schedule(
        Lstrict.indptr, Lstrict.indices, Lstrict.data.astype(np_dtype), n, chunk
    )
    # U is solved bottom-up: mirror indices (i -> n-1-i) so the same
    # forward-level machinery applies, then map back.
    Umir = Ustrict[::-1, ::-1].tocsr()
    rowsU, colsU, valsU, _ = _chunk_schedule(
        Umir.indptr, Umir.indices, Umir.data.astype(np_dtype), n, chunk
    )
    # un-mirror row/col indices (pad value n maps to itself: n-1-(n)= -1 → keep n)
    rowsU = np.where(rowsU < n, n - 1 - rowsU, n)
    colsU = np.where(colsU < n, n - 1 - colsU, n)

    nlevL = int(_levels_from_csr(Lstrict.indptr, Lstrict.indices).max() + 1)
    nlevU = int(_levels_from_csr(Umir.indptr, Umir.indices).max() + 1)
    stats = (int(lu.L.nnz), int(lu.U.nnz), nlevL, nlevU)
    if verbose > 0:
        print(
            f"factorize: n={n} nnz(L)={stats[0]} nnz(U)={stats[1]} "
            f"levels L/U={nlevL}/{nlevU} chunks L/U={rowsL.shape[0]}/{rowsU.shape[0]}"
        )

    return FactorizedMatrix(
        L=_TriFactor(
            rows=jnp.asarray(rowsL),
            cols=jnp.asarray(colsL),
            vals=jnp.asarray(valsL),
            nchunk=rowsL.shape[0],
        ),
        U=_TriFactor(
            rows=jnp.asarray(rowsU),
            cols=jnp.asarray(colsU),
            vals=jnp.asarray(valsU),
            nchunk=rowsU.shape[0],
        ),
        dinv=jnp.asarray((1.0 / udiag).astype(np_dtype)),
        pr_inv=jnp.asarray(np.argsort(lu.perm_r).astype(np.int32)),
        pc=jnp.asarray(lu.perm_c.astype(np.int32)),
        rs=None if rs is None else jnp.asarray(rs.astype(np_dtype)),
        n=n,
        stats=stats,
    )


# ---------------------------------------------------------------------------
# Device-side solve
# ---------------------------------------------------------------------------


def _chunked_trisolve(F: _TriFactor, b: jax.Array, dinv: Optional[jax.Array]):
    """Solve a (unit-diagonal if dinv is None) triangular system whose strict
    part is chunk-scheduled in F. b: (n, m). Returns x: (n, m)."""
    n, m = b.shape
    x = jnp.zeros((n + 1, m), b.dtype)
    b_pad = jnp.concatenate([b, jnp.zeros((1, m), b.dtype)], axis=0)
    dinv_pad = (
        None
        if dinv is None
        else jnp.concatenate([dinv, jnp.zeros((1,), dinv.dtype)])
    )

    def body(c, x):
        rows = F.rows[c]  # (C,)
        cols = F.cols[c]  # (C, kmax)
        vals = F.vals[c]
        deps = x[cols]  # (C, kmax, m) gather
        acc = jnp.einsum("ck,ckm->cm", vals, deps,
                         precision=jax.lax.Precision.HIGHEST)
        xc = b_pad[rows] - acc
        if dinv_pad is not None:
            xc = xc * dinv_pad[rows][:, None]
        return x.at[rows].set(xc, mode="drop", unique_indices=False)

    x = lax.fori_loop(0, F.nchunk, body, x)
    return x[:n]


def lu_solve(F: FactorizedMatrix, X: jax.Array) -> jax.Array:
    """Multi-RHS solve A^-1 X via the externalized factors. Jittable.

    Pipeline mirrors kernels_cpp.hh:660-755: (scale+)P-permute -> L forward
    solve -> U backward solve (with diagonal division) -> Q-permute on store.
    """
    if F.rs is not None:
        X = X * F.rs[:, None]  # fused Rs scale (kernels_cpp.hh:682-705)
    Y = X[F.pr_inv]
    Z = _chunked_trisolve(F.L, Y, None)
    W = _chunked_trisolve(F.U, Z, F.dinv)
    return W[F.pc]


def lu_inverse_factory(A_sh, chunk: int = 512, **kw):
    """``inverse=`` factory for the solvers: factorize once on the host,
    return the closure-free pair ``(F, fn)`` with ``fn(F, X) = A^-1 X``
    (reference: factorize once at eigensolver.hh:156,256, apply every
    iteration). The pair form keeps the gather tables out of XLA constants —
    the solvers thread F through jit as an argument."""
    F = factorize(A_sh, chunk=chunk, **kw)
    return F, _lu_solve_fn


def _lu_solve_fn(F_, X):
    # module-level (stable identity): the solver cores key their jit cache
    # on this function object, so a per-factory closure would retrace and
    # re-ship the compile RPC on every solve
    return lu_solve(F_, X).astype(X.dtype)
