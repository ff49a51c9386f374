"""Blocked multivector orthonormalization and dot products.

Reformulation of the reference kernels
(dune/eigensolver/kernels_cpp.hh):

* ``dot_products_diagonal`` — per-column dots, the Rayleigh-quotient kernel
  (reference :24-55).
* ``dot_products_all`` — full m x m Gram (reference :58-96); one matmul.
* ``orthonormalize_blocked_t`` — the reference orthonormalizes each b-column
  block by LU-factorizing its Gram matrix and right-multiplying by
  ``U^-1 . D^-1/2`` (reference :231-306), which is exactly Cholesky-QR
  (``Q = X @ chol(X^T X)^-T``), then projects all later blocks against the
  finished block with rank-b updates (reference :308-349). Here every piece
  is a dense matmul/triangular-solve, and the Gram matrices can be
  all-reduced across a device mesh via ``gram_reduce`` (the collective
  orthogonalization the single-process reference lacks).
* ``b_orthonormalize_blocked_t`` — B-inner-product variant that keeps
  ``P = B @ (current block)`` resident (reference :356-591) and returns the
  max |R_kj| loss-of-orthogonality monitor exactly like the reference
  (reference :369,466,568,590).

Layout: the ``_t`` functions operate on the TRANSPOSED multivector (m, n*)
— m column-vectors as contiguous rows, the layout the DIA SpMM streams —
and run the block sweep as a ``lax.fori_loop`` over a preallocated prefix
buffer, so the trace is O(m/b) matmuls regardless of m (the round-1
per-block concat loop traced O((m/b)^2) slices, which exploded compile time
for the adaptive GenEO driver's growing nev). Projection against the prefix
uses the FULL buffer each block: unfinished rows are zero and contribute
nothing, exactly like masked prefix sums. The guarded persistent layout's
zero guard columns pass through untouched (all updates are left-multiplies
by m x m matrices plus row scalings).

The (n, m) column-layout entry points are kept as thin transposing wrappers
for oracle-facing code.

For f32/bf16, pass ``iterations=2`` to run
the sweep twice (CholeskyQR2), which restores orthogonality to machine
precision as long as the first pass succeeds.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

# Gram matrices feed Cholesky: always full float32 precision (no TF32).
_PREC = lax.Precision.HIGHEST


def dot_products_diagonal(Q1: jax.Array, Q2: jax.Array) -> jax.Array:
    """diag(Q1^T @ Q2): dot of each column of Q1 with same column of Q2."""
    return jnp.sum(Q1 * Q2, axis=0)


def dot_products_diagonal_t(Q1t: jax.Array, Q2t: jax.Array) -> jax.Array:
    """Per-vector dots in the transposed layout: diag(Q1 Q2^T), (m,)."""
    return jnp.sum(Q1t * Q2t, axis=1)


def dot_products_all(Q1: jax.Array, Q2: jax.Array) -> jax.Array:
    """Full Gram matrix Q1^T @ Q2 (m x m)."""
    return jnp.dot(Q1.T, Q2, precision=_PREC)


def _small_chol(G: jax.Array) -> jax.Array:
    """Lower Cholesky of a block Gram matrix; fully unrolled for the static
    small block sizes (8x8 jnp.linalg.cholesky lowers to a serialized XLA
    loop — see ops/smalllinalg.py)."""
    from dune_eigensolver_tpu.ops.smalllinalg import _UNROLL_MAX, cholesky_unrolled

    if G.shape[0] <= _UNROLL_MAX:
        return cholesky_unrolled(G)
    return jnp.linalg.cholesky(G)


def _left_lower_solve(R: jax.Array, Xk: jax.Array) -> jax.Array:
    """R^-1 @ Xk for lower-triangular R, rows of Xk contiguous (unrolled)."""
    from dune_eigensolver_tpu.ops.smalllinalg import _UNROLL_MAX, solve_lower_left

    if R.shape[0] <= _UNROLL_MAX:
        return solve_lower_left(R, Xk)
    return lax.linalg.triangular_solve(R, Xk, left_side=True, lower=True)


def _whiten_apply(Gr: jax.Array, eps: float, Xs: tuple) -> tuple:
    """Apply the block-whitening transform of the (floored) Gram ``Gr`` to
    every array in ``Xs``: normally ``chol(Gr)^-1 @ Xi`` (the CholeskyQR
    step, reference kernels_cpp.hh:231-306), with a ``lax.cond``-gated
    SPECTRAL fallback when the Cholesky comes out non-finite.

    The relative eps floor cannot save a block whose Gram is numerically
    rank-deficient at its own scale — e.g. the near-converged residual
    blocks a nested-iteration seed produces, where the f32 Gram of the
    [X, W, P] search basis has trailing eigenvalues below the n~1e7
    accumulation roundoff and the Cholesky hits a negative pivot -> NaN
    that no downstream step removes. The fallback whitens through the
    eigendecomposition with eigenvalues clipped at a relative floor:
    healthy directions are orthonormalized exactly as CholeskyQR would,
    defective ones become bounded noise rows (the same "projected to
    noise, never selected by Rayleigh-Ritz" contract as the eps floor),
    and an exactly-zero block stays zero instead of dividing 0/0. The
    eigh branch only EXECUTES when the Cholesky failed, so the healthy
    hot path is unchanged.

    The branch carries only the (b, b) transform — never the (b, n*)
    blocks, which as cond operands would cost extra full-block HBM buffers
    (the first version OOM'd the 10M-dof north star exactly that way); the
    big blocks see one b x b left-matmul either way.
    """
    L = _small_chol(Gr)
    b = Gr.shape[0]
    eye = jnp.eye(b, dtype=Gr.dtype)

    def chol_branch(_):
        return _left_lower_solve(L, eye)

    def eigh_branch(_):
        w, V = jnp.linalg.eigh(Gr)
        floor = max(eps, 1e-7) * jnp.maximum(
            jnp.trace(Gr) / b, jnp.asarray(1e-30, Gr.dtype)
        )
        # T = diag(w^-1/2) V^T  =>  T Gr T^T = I on the clipped spectrum
        return (V / jnp.sqrt(jnp.maximum(w, floor))[None, :]).T

    T = lax.cond(jnp.isfinite(L).all(), chol_branch, eigh_branch, None)
    return tuple(jnp.dot(T, Xi, precision=_PREC) for Xi in Xs)


def _chol_normalize_t(Xk: jax.Array, G: jax.Array, eps: float) -> jax.Array:
    """chol(G)^-1 @ Xk for SPD G (transposed-layout CholeskyQR step)."""
    G = 0.5 * (G + G.T)
    # tiny relative regularization guards chol against rank deficiency of a
    # random block; mirrors the reference's reliance on benign Gram matrices.
    G = G + eps * jnp.trace(G) / G.shape[0] * jnp.eye(G.shape[0], dtype=G.dtype)
    return _whiten_apply(G, eps, (Xk,))[0]


def orthonormalize_blocked_t(
    Xt: jax.Array,
    block: int = 8,
    gram_reduce: Optional[Callable[[jax.Array], jax.Array]] = None,
    iterations: int = 1,
    eps: float = 0.0,
) -> jax.Array:
    """Orthonormalize the rows of the transposed multivector Xt (m, n*)
    block by block (Cholesky-QR per block + projection of later blocks
    against the finished prefix). Semantics match the reference's
    orthonormalize_blocked (kernels_cpp.hh:180-351).

    gram_reduce: optional allreduce (e.g. ``lambda g: psum(g, 'rows')``)
    applied to every Gram/projection matrix for sharded Xt.
    """
    m, _ = Xt.shape
    if m % block != 0:
        raise ValueError(f"orthonormalize_blocked_t: m={m} not multiple of {block}")
    reduce_ = gram_reduce or (lambda g: g)
    nb = m // block

    if nb == 1:
        # single-block fast path = plain CholeskyQR of the whole multivector:
        # no prefix exists, so the projection matmuls (two full passes over an
        # all-zero (m, n*) buffer) are dropped entirely
        for _ in range(iterations):
            G = reduce_(jnp.dot(Xt, Xt.T, precision=_PREC))
            Xt = _chol_normalize_t(Xt, G, eps)
        return Xt

    for _ in range(iterations):
        X = Xt

        def body(i, buf):
            Xk = lax.dynamic_slice_in_dim(X, i * block, block, axis=0)
            # project against ALL finished blocks at once: unfinished rows of
            # the prefix buffer are zero, so S has zero rows there and the
            # update is exact (reference rank-b updates, kernels_cpp.hh:308)
            S = reduce_(jnp.dot(buf, Xk.T, precision=_PREC))  # (m, b)
            Xk = Xk - jnp.dot(S.T, buf, precision=_PREC)
            G = reduce_(jnp.dot(Xk, Xk.T, precision=_PREC))
            Xk = _chol_normalize_t(Xk, G, eps)
            return lax.dynamic_update_slice_in_dim(buf, Xk, i * block, axis=0)

        Xt = lax.fori_loop(0, nb, body, jnp.zeros_like(X))
    return Xt


def b_orthonormalize_blocked_t(
    b_op,
    Xt: jax.Array,
    block: int = 8,
    gram_reduce: Optional[Callable[[jax.Array], jax.Array]] = None,
    iterations: int = 1,
    eps: float = 0.0,
    return_mass: bool = False,
):
    """B-orthonormalize the rows of Xt (m, n*): on return X^T B X = I.

    ``b_op`` is either a sparse container (anything ``spmm_t`` accepts) or a
    callable ``Xt -> (B @ X)^T``. Returns ``(Xt, norm)`` where ``norm`` is
    the maximum absolute off-diagonal Gram/projection coefficient observed —
    the loss-of-orthogonality monitor of the reference
    (kernels_cpp.hh:369,466,568,590).

    ``return_mass=True`` additionally returns the per-vector B-mass
    ``diag(Gram)`` measured after projection but before normalization, on
    the FIRST sweep: for a singular B (the GenEO partition-of-unity mass,
    src/dune-eigensolver.cc:124-143) a vector in null(B) has mass ~ eps and
    only survives normalization through the regularization floor — callers
    (LOBPCG) use the mass to identify and deflate such junk directions.

    Like the reference (:379-395), ``P = B @ (pivot block)`` is recomputed
    per block so it reflects earlier projections, then kept consistent
    through the block's normalization.
    """
    from dune_eigensolver_tpu.sparse.spmm import spmm_t

    apply_b = b_op if callable(b_op) else (lambda V: spmm_t(b_op, V))
    m, _ = Xt.shape
    if m % block != 0:
        raise ValueError(f"b_orthonormalize_blocked_t: m={m} not multiple of {block}")
    reduce_ = gram_reduce or (lambda g: g)
    nb = m // block
    offdiag = ~jnp.eye(block, dtype=bool)

    norm = jnp.zeros((), dtype=Xt.dtype)
    mass = jnp.zeros((m,), dtype=Xt.dtype)

    if nb == 1:
        # single-block fast path = B-inner-product CholeskyQR of the whole
        # multivector: skips the zero-prefix projection passes AND the
        # triangular solve of the B-image (only needed to project later
        # blocks, of which there are none)
        for sweep in range(iterations):
            Pk = apply_b(Xt)
            G = reduce_(jnp.dot(Pk, Xt.T, precision=_PREC))
            norm = jnp.maximum(norm, jnp.max(jnp.abs(jnp.where(offdiag, G, 0))))
            if sweep == 0:
                mass = jnp.diag(G)
            G = 0.5 * (G + G.T)
            Gr = G + eps * jnp.trace(G) / m * jnp.eye(m, dtype=G.dtype)
            (Xt,) = _whiten_apply(Gr, eps, (Xt,))
        if return_mass:
            return Xt, norm, mass
        return Xt, norm

    for sweep in range(iterations):
        X = Xt

        def body(i, state):
            bufx, bufp, norm, mass_acc = state
            Xk = lax.dynamic_slice_in_dim(X, i * block, block, axis=0)
            # project against finished blocks via their B-images
            # (reference kernels_cpp.hh:542-584)
            S = reduce_(jnp.dot(bufp, Xk.T, precision=_PREC))  # (m, b)
            norm = jnp.maximum(norm, jnp.max(jnp.abs(S)))
            Xk = Xk - jnp.dot(S.T, bufx, precision=_PREC)
            Pk = apply_b(Xk)
            G = reduce_(jnp.dot(Pk, Xk.T, precision=_PREC))
            norm = jnp.maximum(norm, jnp.max(jnp.abs(jnp.where(offdiag, G, 0))))
            mass_acc = lax.dynamic_update_slice_in_dim(
                mass_acc, jnp.diag(G), i * block, axis=0
            )
            G = 0.5 * (G + G.T)
            Gr = G + eps * jnp.trace(G) / block * jnp.eye(block, dtype=G.dtype)
            Xk, Pk = _whiten_apply(Gr, eps, (Xk, Pk))
            bufx = lax.dynamic_update_slice_in_dim(bufx, Xk, i * block, axis=0)
            bufp = lax.dynamic_update_slice_in_dim(bufp, Pk, i * block, axis=0)
            return bufx, bufp, norm, mass_acc

        bufx, _, norm, mass_sweep = lax.fori_loop(
            0,
            nb,
            body,
            (jnp.zeros_like(X), jnp.zeros_like(X), norm, jnp.zeros((m,), Xt.dtype)),
        )
        Xt = bufx
        if sweep == 0:
            mass = mass_sweep
    if return_mass:
        return Xt, norm, mass
    return Xt, norm


# ---------------------------------------------------------------------------
# Column-layout (n, m) wrappers — oracle-facing / legacy entry points
# ---------------------------------------------------------------------------


def orthonormalize_blocked(
    X: jax.Array,
    block: int = 8,
    gram_reduce: Optional[Callable[[jax.Array], jax.Array]] = None,
    iterations: int = 1,
    eps: float = 0.0,
) -> jax.Array:
    """Column-layout wrapper over ``orthonormalize_blocked_t``."""
    return orthonormalize_blocked_t(
        X.T, block=block, gram_reduce=gram_reduce, iterations=iterations, eps=eps
    ).T


def b_orthonormalize_blocked(
    b_op,
    X: jax.Array,
    block: int = 8,
    gram_reduce: Optional[Callable[[jax.Array], jax.Array]] = None,
    iterations: int = 1,
    eps: float = 0.0,
    return_mass: bool = False,
):
    """Column-layout wrapper over ``b_orthonormalize_blocked_t``."""
    from dune_eigensolver_tpu.sparse.spmm import spmm

    if callable(b_op):
        apply_b_t = lambda Vt: b_op(Vt.T).T  # noqa: E731
    else:
        apply_b_t = lambda Vt: spmm(b_op, Vt.T).T  # noqa: E731
    out = b_orthonormalize_blocked_t(
        apply_b_t,
        X.T,
        block=block,
        gram_reduce=gram_reduce,
        iterations=iterations,
        eps=eps,
        return_mass=return_mass,
    )
    if return_mass:
        Xt, norm, mass = out
        return Xt.T, norm, mass
    Xt, norm = out
    return Xt.T, norm
