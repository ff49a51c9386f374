"""Tall-skinny SpMM: ``Y = A @ X`` for the sparse containers.

Counterpart of the reference's multi-RHS sparse kernels
(``matmul_sparse_tallskinny_{naive,blocked,avx2_b8,neon_b8}``, reference:
dune/eigensolver/kernels_cpp.hh:596-657, kernels_avx2.hh:1021-1059,
kernels_neon.hh:1314-1361). The reference streams CSR rows once per 8-column
block and broadcasts each scalar ``a_ij`` across a SIMD register; here XLA
vectorizes over both the rows and the m columns:

* DIA: each diagonal is a constant-offset slice of X fused-multiply-added
  into the output — no gathers at all, pure streaming (the speed-of-light
  formulation for the stencil operators in the reference driver).
* ELL: row gather of X + FMA over the padded row width.
* BSR: block-row gather + small dense block contraction.

Every contraction asks for ``Precision.HIGHEST``, so float32 products never
run in TF32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from dune_eigensolver_tpu.sparse.formats import BSRMatrix, DIAMatrix, ELLMatrix


def dia_spmm(A: DIAMatrix, X: jax.Array) -> jax.Array:
    """Y = A @ X with A in DIA format. X: (n, m) tall-skinny."""
    n, m = X.shape
    if A.shape[1] != n:
        raise ValueError(f"dia_spmm: shape mismatch {A.shape} @ {X.shape}")
    halo = max((abs(o) for o in A.offsets), default=0)
    Xp = jnp.pad(X, ((halo, halo), (0, 0)))
    acc = jnp.zeros_like(X)
    for d, off in enumerate(A.offsets):
        shifted = lax.slice(Xp, (halo + off, 0), (halo + off + n, m))
        acc = acc + A.data[d][:, None] * shifted
    return acc


def ell_spmm(A: ELLMatrix, X: jax.Array) -> jax.Array:
    """Y = A @ X with A in ELL format. X: (n_cols, m)."""
    gathered = jnp.take(X, A.cols, axis=0)  # (n, k, m)
    return jnp.einsum(
        "nk,nkm->nm", A.data, gathered, preferred_element_type=X.dtype,
        precision=lax.Precision.HIGHEST,
    )


def bsr_spmm(A: BSRMatrix, X: jax.Array) -> jax.Array:
    """Y = A @ X with A in block-ELL format. X: (n_cols, m)."""
    br, bc = A.block
    m = X.shape[1]
    Xb = X.reshape(A.shape[1] // bc, bc, m)
    gathered = jnp.take(Xb, A.bcols, axis=0)  # (nbr, k, bc, m)
    Yb = jnp.einsum(
        "rkab,rkbm->ram", A.bdata, gathered, preferred_element_type=X.dtype,
        precision=lax.Precision.HIGHEST,
    )
    return Yb.reshape(A.shape[0], m)


def spmm(A, X: jax.Array) -> jax.Array:
    """Dispatch SpMM on container type."""
    if isinstance(A, DIAMatrix):
        return dia_spmm(A, X)
    if isinstance(A, ELLMatrix):
        return ell_spmm(A, X)
    if isinstance(A, BSRMatrix):
        return bsr_spmm(A, X)
    raise TypeError(f"spmm: unsupported operand type {type(A)}")


# ---------------------------------------------------------------------------
# Transposed (m, n) layout — the solver-internal hot path, the analogue of
# the reference's contiguous 8-RHS blocks (multivector.hh:130-139). Guarded
# (PaddedDIA) operands keep the persistent zero-guarded layout.
# ---------------------------------------------------------------------------


def ell_spmm_t(A: ELLMatrix, Xt: jax.Array) -> jax.Array:
    """Yt = (A @ Xt.T).T with A in ELL format. Xt: (m, n_cols)."""
    gathered = jnp.take(Xt, A.cols, axis=1)  # (m, n, k)
    return jnp.einsum(
        "nk,mnk->mn", A.data, gathered, preferred_element_type=Xt.dtype,
        precision=lax.Precision.HIGHEST,
    )


def bsr_spmm_t(A: BSRMatrix, Xt: jax.Array) -> jax.Array:
    """Yt = (A @ Xt.T).T with A in block-ELL format. Xt: (m, n_cols)."""
    br, bc = A.block
    m = Xt.shape[0]
    Xb = Xt.reshape(m, A.shape[1] // bc, bc)
    gathered = jnp.take(Xb, A.bcols, axis=1)  # (m, nbr, k, bc)
    Yb = jnp.einsum(
        "rkab,mrkb->mra", A.bdata, gathered, preferred_element_type=Xt.dtype,
        precision=lax.Precision.HIGHEST,
    )
    return Yb.reshape(m, A.shape[0])


def spmm_t(A, Xt: jax.Array) -> jax.Array:
    """Transposed-layout SpMM dispatch: Yt (m, n*) = (A @ X). PaddedDIA
    operands run on the guarded layout (kernels/dia_spmm.py); plain
    containers run the XLA formulations."""
    from dune_eigensolver_tpu.kernels.dia_spmm import (
        PaddedDIA,
        dia_spmm_t_xla,
        padded_spmm,
    )
    from dune_eigensolver_tpu.utils.paranoid import nan_check

    if isinstance(A, PaddedDIA):
        return nan_check(padded_spmm(A, Xt), "padded_spmm")
    if isinstance(A, DIAMatrix):
        return dia_spmm_t_xla(A, Xt)
    if isinstance(A, ELLMatrix):
        return ell_spmm_t(A, Xt)
    if isinstance(A, BSRMatrix):
        return bsr_spmm_t(A, Xt)
    raise TypeError(f"spmm_t: unsupported operand type {type(A)}")
