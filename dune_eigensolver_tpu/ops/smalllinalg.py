"""Unrolled small-matrix factorizations for the blocked orthonormalization.

``jnp.linalg.cholesky`` / ``triangular_solve`` on an 8x8 operand lower to
XLA while-loops with dynamic slicing, where each tiny dynamic step
serializes. The ortho block size is a static 8 (the reference's
SIMD width, multivector.hh:26), so the b x b Gram factorization can be
FULLY UNROLLED into static scalar/vector ops that XLA fuses into a handful
of vector instructions — the analogue of the reference's hand-unrolled
register-tile LU of the Gram block (kernels_cpp.hh:231-306).

Used automatically by ops/ortho.py for block sizes <= _UNROLL_MAX.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_UNROLL_MAX = 16


def cholesky_unrolled(G: jax.Array) -> jax.Array:
    """Lower Cholesky factor of a small SPD matrix, fully unrolled
    (Cholesky-Banachiewicz row by row; b static and small)."""
    b = G.shape[0]
    L = [[None] * b for _ in range(b)]
    for i in range(b):
        for j in range(i + 1):
            s = G[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    rows = [
        jnp.stack([L[i][j] if j <= i else jnp.zeros((), G.dtype) for j in range(b)])
        for i in range(b)
    ]
    return jnp.stack(rows)


def solve_lower_transpose_right(X: jax.Array, L: jax.Array) -> jax.Array:
    """X @ L^-T for small lower-triangular L, unrolled column by column.

    Forward substitution on columns: y_j = (x_j - sum_{k<j} L[j,k] y_k) / L[j,j].
    X: (n, b); returns (n, b). This is the Cholesky-QR normalization step
    (reference right-multiply by U^-1 D^-1/2, kernels_cpp.hh:262-306).
    """
    b = L.shape[0]
    cols = []
    for j in range(b):
        y = X[:, j]
        for k in range(j):
            y = y - L[j, k] * cols[k]
        cols.append(y / L[j, j])
    return jnp.stack(cols, axis=1)


def solve_lower_left(L: jax.Array, B: jax.Array) -> jax.Array:
    """L^-1 @ B for small lower-triangular L, unrolled row by row.

    Forward substitution on ROWS of the transposed multivector layout:
    y_i = (b_i - sum_{k<i} L[i,k] y_k) / L[i,i] with b_i = B[i] a contiguous
    (n,)-row. This is the transposed-layout Cholesky-QR normalization
    (columns of X^T are rows here), so no (n, b) transposes are needed.
    B: (b, n); returns (b, n).
    """
    b = L.shape[0]
    rows = []
    for i in range(b):
        y = B[i]
        for k in range(i):
            y = y - L[i, k] * rows[k]
        rows.append(y / L[i, i])
    return jnp.stack(rows, axis=0)
