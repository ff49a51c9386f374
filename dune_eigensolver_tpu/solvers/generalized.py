"""Generalized eigenproblem solver: smallest eigenpairs of ``A x = lambda B x``
by shift-invert inverse iteration with B-orthonormalization.

Reference semantics: ``GeneralizedInverse`` (dune/eigensolver/
eigensolver.hh:204-351), the flagship solver (GenEO coarse-space setup):

  A' = A + shift*B + reg*I  (pattern(B) must be within pattern(A),
                             eigensolver.hh:241-252)
  factorize A' once; B-orthonormalize Q
  loop:  Q2 = B Q1;  Q1 = A'^-1 Q2;  B-orthonormalize Q1
         rayleigh: ra_i = (Q1^T A' Q1)_ii - shift
         relerror = max_i |ra1_i - ra2_i| / max_i ra1_i
         stop when iter > min_iter and relerror < tol

The reference's stopping test uses bitwise `&` at eigensolver.hh:323 (a bug
that still forces >= 11 iterations because of the iter>10 clause); we use the
intended logical AND with configurable ``min_iter`` defaulting to the same 10.

The iteration state is the TRANSPOSED multivector (m, n*), guarded for the
DIA kernel on DIA operands (solvers/engine.py), and runs in a module-level
jitted core whose operands (A', B, factorization aux, Q0) are explicit
arguments: closing over a multi-hundred-MB factorization would embed it as
an XLA constant in every trace.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from dune_eigensolver_tpu.ops.ortho import (
    b_orthonormalize_blocked_t,
    dot_products_diagonal_t,
)
from dune_eigensolver_tpu.solvers.engine import (
    adapt_inverse,
    from_internal_vectors,
    make_engine,
    to_internal,
)
from dune_eigensolver_tpu.solvers.result import EigenResult, sort_result_t
from dune_eigensolver_tpu.solvers.standard import (
    _spec_of,
    normalize_inverse,
    padded_width,
    random_multivector_t,
)
from dune_eigensolver_tpu.sparse.spmm import spmm_t


def _gen_core(A_int, B_int, inv_aux, Q0, hooks, cfg):
    apply_a_h, apply_b_h, gram_reduce, inv_fn = hooks
    (
        nev,
        tol,
        maxiter,
        shift_eval,
        block,
        min_iter,
        ortho_iterations,
        rayleigh_ritz,
        n,
        dtype,
    ) = cfg
    # each hook falls back independently to the internal-operand SpMM
    # (round 1 crashed when only SOME hooks were supplied)
    apply_a = apply_a_h or (lambda X: spmm_t(A_int, X))
    apply_b = apply_b_h or (lambda X: spmm_t(B_int, X))
    reduce_ = gram_reduce or (lambda g: g)
    shift_ = jnp.asarray(shift_eval, dtype)
    spec = _spec_of(A_int)
    b_ortho = partial(
        b_orthonormalize_blocked_t,
        apply_b,
        block=block,
        gram_reduce=gram_reduce,
        iterations=ortho_iterations,
    )

    def rayleigh(Q):
        """Ritz values (and rotated Q). With rayleigh_ritz the m x m
        projected problem Q^T A Q (B-orthonormal Q) is diagonalized and Q is
        rotated into the Ritz basis — beyond the reference's per-column
        quotients (eigensolver.hh:308-312), converging per-vector at the
        subspace-iteration rate instead of the coupled block rate."""
        AQ = apply_a(Q)
        if not rayleigh_ritz:
            return reduce_(dot_products_diagonal_t(AQ, Q)) - shift_, Q
        G = reduce_(jnp.dot(AQ, Q.T, precision=jax.lax.Precision.HIGHEST))
        G = 0.5 * (G + G.T)
        lam, V = jnp.linalg.eigh(G)
        return lam - shift_, jnp.dot(V.T, Q, precision=jax.lax.Precision.HIGHEST)

    Q, norm0 = b_ortho(Q0)
    ra2, Q = rayleigh(Q)

    def body(state):
        Q, ra2, it, _, _ = state
        Q2 = apply_b(Q)
        Q1 = inv_fn(inv_aux, Q2)
        Q1, norm = b_ortho(Q1)
        ra1, Q1 = rayleigh(Q1)
        relerror = jnp.max(jnp.abs(ra1 - ra2)) / jnp.max(ra1)
        return Q1, ra1, it + 1, relerror, norm

    def cond(state):
        _, _, it, relerror, _ = state
        return (it < maxiter) & ((it <= min_iter) | (relerror >= tol))

    state = (
        Q,
        ra2,
        jnp.zeros((), jnp.int32),
        jnp.asarray(jnp.inf, dtype),
        norm0,
    )
    Q, ra, it, relerror, norm = lax.while_loop(cond, body, state)
    evals, evecs_t = sort_result_t(ra, Q, nev, descending=False)
    return EigenResult(
        eigenvalues=evals,
        eigenvectors=from_internal_vectors(evecs_t, spec, n),
        iterations=it,
        converged=relerror < tol,
        criterion=relerror,
        ortho_monitor=norm,
    )


_gen_core_jit = jax.jit(_gen_core, static_argnums=(4, 5))


def generalized_inverse(
    A,
    B,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    reg: float = 0.0,
    block: int = 8,
    seed: int = 123,
    min_iter: int = 10,
    ortho_iterations: int = 1,
    rayleigh_ritz: bool = False,
    inverse: Optional[Callable] = None,
    apply_a: Optional[Callable] = None,
    apply_b: Optional[Callable] = None,
    gram_reduce: Optional[Callable] = None,
    q0: Optional[jax.Array] = None,
    eval_shift: Optional[float] = None,
    dtype=None,
    force_padded: Optional[bool] = None,
) -> EigenResult:
    """Smallest-nev eigenpairs of ``A x = lambda B x``.

    ``inverse``: factory mapping the shifted operator A' = A + shift*B +
    reg*I to a multi-RHS solve. It may return either a plain callable
    ``X -> A'^-1 X`` or a closure-free pair ``(aux, fn)`` with
    ``fn(aux, X)`` (preferred — aux is threaded through jit as an
    argument). Column-layout factories are bridged to the internal
    transposed layout automatically; factories marked ``internal`` receive
    the internal (guarded PaddedDIA) operand and run the fast SpMM in their
    inner loops. Default: the block-banded partitioned-inverse direct solve
    for DIA operands, host-LU gather trisolve otherwise; pass
    ``cg_inverse_factory(...)`` for the matrix-free path (used by the
    distributed layer).

    ``apply_a``/``apply_b``/``gram_reduce``/``q0`` let the distributed layer
    inject halo-exchange SpMMs, a psum, and a pre-sharded start block (all
    transposed (m, n_local)). When a caller pre-folds the shift into
    ``apply_a`` (sharded path), pass ``shift=0`` and the original shift as
    ``eval_shift`` so the Rayleigh quotients are un-shifted correctly
    (eigensolver.hh:311-312).
    """
    from dune_eigensolver_tpu.solvers.standard import shifted_operand

    dtype = dtype or A.dtype
    m = padded_width(nev, block)
    n = A.shape[0]
    dist_mode = apply_a is not None and apply_b is not None
    if dist_mode:
        A_int = B_int = None
        layout = None
        inv_aux, inv_fn = normalize_inverse(inverse(None))
    else:
        from dune_eigensolver_tpu.solvers.engine import memoized_setup

        if inverse is None:
            from dune_eigensolver_tpu.factorize import default_inverse_factory

            inverse = default_inverse_factory

        def _build():
            A_sh = shifted_operand(A, B, shift, reg)
            A_int, B_int, layout, _spec = make_engine(
                A_sh, B, m, force_padded
            )
            if getattr(inverse, "internal", False):
                aux, fn = normalize_inverse(inverse(A_int))
            else:
                aux, fn = normalize_inverse(inverse(A_sh))
            aux, fn = adapt_inverse(aux, fn, layout)
            return A_int, B_int, layout, aux, fn

        # setup (shift fold + engine planning + factorization + upload) is
        # memoized on the operand identities: repeated solves on the same
        # pencil (the GenEO / adaptive pattern) pay it once
        A_int, B_int, layout, inv_aux, inv_fn = memoized_setup(
            ((A, inverse) if B is None else (A, B, inverse)),
            ("gen", float(shift), float(reg), m, force_padded),
            _build,
        )
    hooked = dist_mode or gram_reduce is not None
    if q0 is not None:
        Q0 = q0 if hooked else to_internal(q0.T, layout)
    else:
        Q0 = to_internal(
            random_multivector_t(jax.random.PRNGKey(seed), n, m, dtype), layout
        )
    cfg = (
        nev,
        float(tol),
        int(maxiter),
        float(shift if eval_shift is None else eval_shift),
        int(block),
        int(min_iter),
        int(ortho_iterations),
        bool(rayleigh_ritz),
        int(n),
        jnp.dtype(dtype),
    )
    hooks = (apply_a, apply_b, gram_reduce, inv_fn)
    # custom hooks (dist layer) run inside an enclosing shard_map trace; call
    # the core inline there. The default single-chip path goes through the
    # cached jit with explicit operands.
    if apply_a is None and apply_b is None and gram_reduce is None:
        return _gen_core_jit(A_int, B_int, inv_aux, Q0, hooks, cfg)
    return _gen_core(A_int, B_int, inv_aux, Q0, hooks, cfg)
