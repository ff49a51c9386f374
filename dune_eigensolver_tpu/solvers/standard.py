"""Standard eigenproblem solvers: blocked orthogonal (power) iteration for
the largest eigenpairs, and shift-invert inverse iteration for the smallest.

Reference semantics: ``StandardLargest`` / ``StandardInverse``
(dune/eigensolver/eigensolver.hh:28-112, 116-198). Differences by design:

* functional: the reference shifts A in place (eigensolver.hh:59-66); we
  shift a copy of the diagonal.
* the iteration runs under ``lax.while_loop`` inside a module-level jitted
  core whose operands are explicit arguments (a closure-captured operand
  would be embedded as an XLA constant on every trace — fatal for the
  multi-hundred-MB banded factorizations).
* the iteration state is the TRANSPOSED multivector (m, n*), guarded for
  the DIA kernel on DIA operands (solvers/engine.py): the whole while-loop
  runs with zero marshalling, the analogue of the reference streaming its
  blocked MultiVector in place (multivector.hh:130).
* eigenpairs are returned sorted (descending for largest, ascending for
  smallest); the reference returns them in iteration order.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from dune_eigensolver_tpu.ops.ortho import (
    dot_products_diagonal_t,
    orthonormalize_blocked_t,
)
from dune_eigensolver_tpu.solvers.engine import (
    adapt_inverse,
    from_internal_vectors,
    make_engine,
    to_internal,
)
from dune_eigensolver_tpu.solvers.result import EigenResult, sort_result_t
from dune_eigensolver_tpu.sparse.spmm import spmm_t


def padded_width(nev: int, block: int) -> int:
    """Round nev up to the block size (reference eigensolver.hh:43)."""
    return -(-nev // block) * block


def random_multivector(key, n: int, m: int, dtype) -> jax.Array:
    """N(0,1) random start block, column layout (reference
    eigensolver.hh:50-55 uses a seeded mt19937; we use the JAX PRNG —
    deterministic given the key)."""
    return jax.random.normal(key, (n, m), dtype=dtype)


def random_multivector_t(key, n: int, m: int, dtype) -> jax.Array:
    """Transposed-layout equivalent of random_multivector (same per-vector
    distribution; the transpose keeps vector k identical to column k)."""
    return jax.random.normal(key, (n, m), dtype=dtype).T


@jax.jit
def _shift_operand_dia(A, B, shift, reg):
    """A + shift*B + reg*I (B=None -> A + shift*I) as ONE jitted call: every
    eager op is a separate dispatch, so the handful of per-diagonal adds in
    axpy would otherwise cost more than they compute."""
    A_sh = A.axpy(shift, B) if B is not None else A.with_shifted_diagonal(shift)
    return A_sh.with_shifted_diagonal(reg)


def shifted_operand(A, B, shift, reg):
    """Shifted/regularized operand with the DIA fast path (single dispatch);
    other formats fall back to their (host-side) axpy."""
    from dune_eigensolver_tpu.sparse.formats import DIAMatrix

    if isinstance(A, DIAMatrix) and (B is None or isinstance(B, DIAMatrix)):
        if shift == 0.0 and reg == 0.0:
            return A
        return _shift_operand_dia(A, B, shift, reg)
    A_sh = A
    if shift != 0.0:
        A_sh = A_sh.axpy(shift, B) if B is not None else A_sh.with_shifted_diagonal(shift)
    if reg != 0.0:
        A_sh = A_sh.with_shifted_diagonal(reg)
    return A_sh


def normalize_inverse(inv_result):
    """Inverse factories may return a plain callable ``X -> A^-1 X`` or a
    closure-free pair ``(aux, fn)`` with ``fn(aux, X)``. Normalize to the
    pair form (aux goes through jit as a real argument)."""
    if (
        isinstance(inv_result, tuple)
        and len(inv_result) == 2
        and callable(inv_result[1])
    ):
        return inv_result
    fn = lambda _aux, X: inv_result(X)  # noqa: E731
    fn.layout_t = getattr(inv_result, "layout_t", False)
    return None, fn


def _ritz_t(reduce_, rayleigh_ritz, Q, AQ, shift_):
    """Ritz values (and rotated Q), transposed layout. rayleigh_ritz=False
    reproduces the reference's per-column Rayleigh quotients
    (eigensolver.hh:84-85); True diagonalizes the m x m projected operator
    and rotates Q into the Ritz basis — faster per-vector convergence for
    one tiny eigh + one (m, m) @ (m, n) rotation."""
    if not rayleigh_ritz:
        return reduce_(dot_products_diagonal_t(Q, AQ)) - shift_, Q
    G = reduce_(jnp.dot(AQ, Q.T, precision=jax.lax.Precision.HIGHEST))
    G = 0.5 * (G + G.T)
    lam, V = jnp.linalg.eigh(G)
    return lam - shift_, jnp.dot(V.T, Q, precision=jax.lax.Precision.HIGHEST)


def _largest_core(A_int, Q0, hooks, cfg):
    apply_a_h, gram_reduce = hooks
    nev, tol, maxiter, shift, block, ortho_iterations, rayleigh_ritz, n, dtype = cfg
    # hook contract: transposed (m, n_local)
    if apply_a_h is None:
        apply_a = lambda X: spmm_t(A_int, X)  # noqa: E731
    else:
        apply_a = apply_a_h
    reduce_ = gram_reduce or (lambda g: g)
    shift_ = jnp.asarray(shift, dtype)
    m = Q0.shape[0]
    spec = _spec_of(A_int)

    ortho = partial(
        orthonormalize_blocked_t,
        block=block,
        gram_reduce=gram_reduce,
        iterations=ortho_iterations,
    )
    Q = ortho(Q0)

    def body(state):
        Q, s_prev, k, _ = state
        Q2 = ortho(apply_a(Q))
        AQ2 = apply_a(Q2)
        s, Q2 = _ritz_t(reduce_, rayleigh_ritz, Q2, AQ2, shift_)
        distance = jnp.max(jnp.abs(s - s_prev))
        return Q2, s, k + 1, distance

    def cond(state):
        _, _, k, distance = state
        # reference loop: k in [1, maxiter); break when k > 1 and
        # distance < tol (eigensolver.hh:75,101-102)
        return (k < maxiter) & ((k < 2) | (distance >= tol))

    s0 = jnp.zeros((m,), dtype)
    Q, s, k, distance = lax.while_loop(
        cond, body, (Q, s0, jnp.zeros((), jnp.int32), jnp.asarray(jnp.inf, dtype))
    )
    evals, evecs_t = sort_result_t(s, Q, nev, descending=True)
    return EigenResult(
        eigenvalues=evals,
        eigenvectors=from_internal_vectors(evecs_t, spec, n),
        iterations=k,
        converged=distance < tol,
        criterion=distance,
        ortho_monitor=jnp.zeros((), dtype),
    )


def _spec_of(A_int):
    """EngineSpec derived from the operand's static metadata (works inside
    jitted cores; dist passes None operands and plain layout)."""
    from dune_eigensolver_tpu.kernels.dia_spmm import PaddedDIA
    from dune_eigensolver_tpu.solvers.engine import EngineSpec

    if isinstance(A_int, PaddedDIA):
        return EngineSpec(A_int.guard, A_int.n, A_int.data.shape[1])
    return EngineSpec(None, None, None)


_largest_core_jit = jax.jit(_largest_core, static_argnums=(2, 3))


def standard_largest(
    A,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    block: int = 8,
    seed: int = 123,
    ortho_iterations: int = 1,
    rayleigh_ritz: bool = False,
    apply_a: Optional[Callable] = None,
    gram_reduce: Optional[Callable] = None,
    q0: Optional[jax.Array] = None,
    dtype=None,
    force_padded: Optional[bool] = None,
) -> EigenResult:
    """Largest-nev eigenpairs of ``A x = lambda x`` by blocked orthogonal
    iteration (reference StandardLargest, eigensolver.hh:28-112).

    Per iteration: Q2 = A' Q1; orthonormalize Q2; Rayleigh quotients via a
    second SpMM + per-column dots; stop when max |lambda^k - lambda^{k-1}|
    < tol (after at least 2 iterations), where A' = A + shift*I.

    ``apply_a``/``gram_reduce``/``q0`` let the distributed layer inject a
    halo-exchange SpMM, a psum, and a pre-sharded start block — all in the
    transposed (m, n_local) layout.
    """
    dtype = dtype or A.dtype
    m = padded_width(nev, block)
    n = A.shape[0]
    if apply_a is None:
        from dune_eigensolver_tpu.solvers.engine import memoized_setup

        def _build():
            A_sh = shifted_operand(A, None, shift, 0.0)
            A_int, _, layout, _spec = make_engine(
                A_sh, None, m, force_padded
            )
            return A_int, layout

        # engine planning/upload memoized on operand identity
        A_int, layout = memoized_setup(
            (A,), ("std_large", float(shift), m, force_padded), _build
        )
    else:
        A_int, layout = None, None
    dist_mode = apply_a is not None or gram_reduce is not None
    if q0 is not None:
        # hooks imply the internal transposed contract; public callers pass
        # the column layout (n, m)
        Q0 = q0 if dist_mode else to_internal(q0.T, layout)
    else:
        Q0 = to_internal(
            random_multivector_t(jax.random.PRNGKey(seed), n, m, dtype), layout
        )
    cfg = (
        nev,
        float(tol),
        int(maxiter),
        float(shift),
        int(block),
        int(ortho_iterations),
        bool(rayleigh_ritz),
        int(n),
        jnp.dtype(dtype),
    )
    hooks = (apply_a, gram_reduce)
    if apply_a is None and gram_reduce is None:
        return _largest_core_jit(A_int, Q0, hooks, cfg)
    return _largest_core(A_int, Q0, hooks, cfg)


def _inverse_core(A_int, inv_aux, Q0, hooks, cfg):
    gram_reduce, inv_fn = hooks
    nev, tol, maxiter, shift, block, ortho_iterations, rayleigh_ritz, n, dtype = cfg
    reduce_ = gram_reduce or (lambda g: g)
    shift_ = jnp.asarray(shift, dtype)
    m = Q0.shape[0]
    spec = _spec_of(A_int)

    ortho = partial(
        orthonormalize_blocked_t,
        block=block,
        gram_reduce=gram_reduce,
        iterations=ortho_iterations,
    )
    Q = ortho(Q0)

    def body(state):
        Q, s_prev, k, _ = state
        Q2 = ortho(inv_fn(inv_aux, Q))
        AQ2 = spmm_t(A_int, Q2)
        s, Q2 = _ritz_t(reduce_, rayleigh_ritz, Q2, AQ2, shift_)
        distance = jnp.max(jnp.abs(s - s_prev))
        return Q2, s, k + 1, distance

    def cond(state):
        _, _, k, distance = state
        return (k < maxiter) & ((k < 2) | (distance >= tol))

    s0 = jnp.zeros((m,), dtype)
    Q, s, k, distance = lax.while_loop(
        cond, body, (Q, s0, jnp.zeros((), jnp.int32), jnp.asarray(jnp.inf, dtype))
    )
    evals, evecs_t = sort_result_t(s, Q, nev, descending=False)
    return EigenResult(
        eigenvalues=evals,
        eigenvectors=from_internal_vectors(evecs_t, spec, n),
        iterations=k,
        converged=distance < tol,
        criterion=distance,
        ortho_monitor=jnp.zeros((), dtype),
    )


_inverse_core_jit = jax.jit(_inverse_core, static_argnums=(3, 4))


def standard_inverse(
    A,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    block: int = 8,
    seed: int = 123,
    ortho_iterations: int = 1,
    rayleigh_ritz: bool = False,
    inverse: Optional[Callable] = None,
    gram_reduce: Optional[Callable] = None,
    q0: Optional[jax.Array] = None,
    dtype=None,
    force_padded: Optional[bool] = None,
) -> EigenResult:
    """Smallest-nev eigenpairs of ``A x = lambda x`` by shift-invert inverse
    orthogonal iteration (reference StandardInverse, eigensolver.hh:116-198).

    ``inverse``: factory mapping the shifted operator A' = A + shift*I to a
    multi-RHS solve; may return a plain callable or a closure-free
    ``(aux, fn)`` pair (see normalize_inverse). Column-layout factories are
    bridged to the internal transposed layout automatically; factories
    marking their fn with ``layout_t`` run natively on it. Defaults to the
    block-banded partitioned-inverse direct solve for DIA operands
    (factorize.banded) and the host-LU gather trisolve otherwise
    (factorize.host_lu). Pass ``factorize.cg.cg_inverse_factory(...)`` for
    the matrix-free path.
    """
    from dune_eigensolver_tpu.solvers.engine import memoized_setup

    dtype = dtype or A.dtype
    m = padded_width(nev, block)
    n = A.shape[0]
    if inverse is None:
        from dune_eigensolver_tpu.factorize import default_inverse_factory

        inverse = default_inverse_factory

    def _build():
        A_sh = shifted_operand(A, None, shift, 0.0)
        A_int, _, layout, _spec = make_engine(A_sh, None, m, force_padded)
        if getattr(inverse, "internal", False):
            aux, fn = normalize_inverse(inverse(A_int))
        else:
            aux, fn = normalize_inverse(inverse(A_sh))
        aux, fn = adapt_inverse(aux, fn, layout)
        return A_int, layout, aux, fn

    # setup memoized on operand identity (see generalized_inverse)
    A_int, layout, inv_aux, inv_fn = memoized_setup(
        (A, inverse), ("std_inv", float(shift), m, force_padded), _build
    )
    if q0 is not None:
        Q0 = q0 if gram_reduce is not None else to_internal(q0.T, layout)
    else:
        Q0 = to_internal(
            random_multivector_t(jax.random.PRNGKey(seed), n, m, dtype), layout
        )
    cfg = (
        nev,
        float(tol),
        int(maxiter),
        float(shift),
        int(block),
        int(ortho_iterations),
        bool(rayleigh_ritz),
        int(n),
        jnp.dtype(dtype),
    )
    hooks = (gram_reduce, inv_fn)
    if gram_reduce is None:
        return _inverse_core_jit(A_int, inv_aux, Q0, hooks, cfg)
    return _inverse_core(A_int, inv_aux, Q0, hooks, cfg)
