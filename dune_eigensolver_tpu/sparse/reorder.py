"""Symmetric reorderings for general-sparsity operands.

Eigenvalues of the pencil (A, B) are invariant under a symmetric
permutation P A P^T / P B P^T, so an eigensolve on an unstructured operator
may be run entirely in RCM order — which bounds the bandwidth, so the
banded direct solve (factorize/reordered.py) and the row-sharded drivers
(dist/windowed.py) apply — and only the eigenVECTORS need permuting back.
The reference leaves ordering to UMFPACK's internals (umfpacktools.hh:
100-111); here ordering is an explicit, user-visible setup step because it
decides which engine the operands can run on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from dune_eigensolver_tpu.factorize.reordered import rcm_bandwidth
from dune_eigensolver_tpu.sparse.formats import (
    BSRMatrix,
    ELLMatrix,
    bsr_from_scipy,
    ell_from_scipy,
)


def rcm_pencil(
    A, B=None, block: Optional[Tuple[int, int]] = None, dtype=None
) -> Tuple[object, Optional[object], np.ndarray]:
    """(A', B', perm) with A' = A[perm][:, perm] in RCM order.

    ``block``: return block-ELL with that block size (block structure must
    be preserved — the permutation is computed on the BLOCK graph so whole
    blocks move together, like the reference's blocklevel-2 BCRS). Without
    ``block``, returns ELL. ``perm`` maps new index -> old index (scalar
    dofs); recover original-order vectors with ``x_old[perm] = x_new``,
    i.e. ``x_old = x_new[argsort? ]`` — concretely
    ``x_old = np.empty_like(x_new); x_old[perm] = x_new``.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    def to_csr(M):
        return sp.csr_matrix(M.to_scipy() if hasattr(M, "to_scipy") else M)

    Sa = to_csr(A)
    Sb = to_csr(B) if B is not None else None
    dtype = dtype or Sa.dtype
    if block is not None:
        br, bc = block
        if br != bc:
            raise ValueError("rcm_pencil: blocks must be square")
        nb = Sa.shape[0] // br
        # block connectivity graph: collapse scalar pattern onto blocks
        pat = Sa.copy()
        pat.data = np.ones_like(pat.data)
        R = sp.kron(sp.eye(nb), np.ones((1, br)))
        G = sp.csr_matrix(R @ pat @ R.T)
        bperm = np.asarray(reverse_cuthill_mckee(G, symmetric_mode=True))
        perm = (bperm[:, None] * br + np.arange(br)[None, :]).ravel()
    else:
        perm, _ = rcm_bandwidth(Sa)
    Sa = Sa[perm][:, perm]
    if Sb is not None:
        Sb = Sb[perm][:, perm]
    if block is not None:
        A2 = bsr_from_scipy(Sa, block=block, dtype=dtype)
        B2 = None if Sb is None else bsr_from_scipy(Sb, block=block, dtype=dtype)
    else:
        A2 = ell_from_scipy(Sa, dtype=dtype)
        B2 = None if Sb is None else ell_from_scipy(Sb, dtype=dtype)
    return A2, B2, np.asarray(perm)


def unpermute_vectors(V: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Map eigenvectors computed in permuted order back: rows reordered so
    row perm[i] of the output is row i of the input."""
    out = np.empty_like(V)
    out[perm] = V
    return out


__all__ = ["rcm_pencil", "unpermute_vectors"]
