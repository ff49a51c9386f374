"""Bandwidth-reduced direct solve for general sparse operands.

The reference hands any BCRS matrix to UMFPACK's fill-reducing ordering
(umfpacktools.hh:100-111). Fill-reducing orderings produce scattered
triangular factors whose row-sequential solve is hostile to a wide-vector
device; the on-device route is the opposite trade: **reverse Cuthill-McKee**
confines
the matrix to a band, the no-pivot band factorization fills only inside the
band, and the solve becomes the block-banded partitioned-inverse scan of
dense matmuls (factorize/banded.py) — more flops, perfectly regular.

``rcm_banded_inverse_factory`` returns the standard closure-free
``(aux, fn)`` pair with the row/column permutation folded in:
``A x = b  <=>  (P A P^T)(P x) = P b``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp


def _to_scipy_csr(A):
    import scipy.sparse as sp

    if hasattr(A, "to_scipy"):
        return sp.csr_matrix(A.to_scipy())
    return sp.csr_matrix(A)


def _bandwidth(S) -> int:
    coo = S.tocoo()
    return int(np.abs(coo.row - coo.col).max()) if coo.nnz else 0


def rcm_bandwidth(A) -> Tuple[np.ndarray, int]:
    """(permutation, bandwidth) for any sparse operand: the RCM ordering,
    or the identity when the given ordering is no wider. Lexicographic
    grid operators are already banded, and RCM's diagonal level sets
    double their bandwidth (``elasticity_2d(512)``: 1025 -> 2039, and 21
    stored diagonals -> 4079)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    S = _to_scipy_csr(A)
    natural = _bandwidth(S)
    perm = np.asarray(reverse_cuthill_mckee(S, symmetric_mode=True))
    bw = _bandwidth(S[perm][:, perm])
    if natural <= bw:
        return np.arange(S.shape[0]), natural
    return perm, bw


def rcm_banded_inverse_factory(
    A,
    C: int = 256,
    dtype=None,
    refine: int = 1,
    perm: Optional[np.ndarray] = None,
    **kw,
):
    """(aux, fn) pair solving with the banded engine on the RCM-permuted
    operator. Raises ValueError if the reduced bandwidth is still too wide
    for the block-banded engine (caller falls back to CG / host-LU)."""
    from dune_eigensolver_tpu.factorize.banded import (
        _DEVICE_BW_MAX,
        banded_inverse_factory,
    )
    from dune_eigensolver_tpu.sparse.formats import dia_from_scipy

    S = _to_scipy_csr(A)
    if perm is None:
        perm, bw = rcm_bandwidth(S)
    else:
        bw = _bandwidth(S[perm][:, perm])
    if bw > _DEVICE_BW_MAX:
        raise ValueError(
            f"rcm_banded_inverse_factory: RCM bandwidth {bw} exceeds "
            f"{_DEVICE_BW_MAX}; use the CG or host-LU engine"
        )
    dtype = dtype or (A.dtype if hasattr(A, "dtype") else S.dtype)
    Sp = S[perm][:, perm]
    A_dia = dia_from_scipy(Sp, dtype=dtype)
    inner_aux, inner_fn = banded_inverse_factory(A_dia, C=C, refine=refine, **kw)
    perm_d = jnp.asarray(perm.astype(np.int32))
    iperm_d = jnp.asarray(np.argsort(perm).astype(np.int32))
    return (inner_aux, perm_d, iperm_d), _rcm_solve_fn(inner_fn)


_RCM_SOLVE_FNS = {}


def _rcm_solve_fn(inner_fn):
    # memoized per inner solve fn: keeps a stable identity so the solver
    # cores' jit caches (keyed on the fn object) hit across factory calls
    if inner_fn not in _RCM_SOLVE_FNS:

        def solve(aux, X, _inner_fn=inner_fn):
            inner, p, ip = aux
            return _inner_fn(inner, X[p])[ip]

        _RCM_SOLVE_FNS[inner_fn] = solve
    return _RCM_SOLVE_FNS[inner_fn]
