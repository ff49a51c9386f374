"""Matrix-free multi-RHS conjugate-gradient inverse application.

The reference applies ``A'^-1`` through an externalized UMFPACK LU
factorization (umfpacktools.hh + kernels_cpp.hh:660-755). A sparse triangular
solve is row-sequential and fights a wide-vector device (SURVEY.md §7
"hard parts"), so the on-device default for SPD shifted operators is an
inner Krylov solve: Jacobi-preconditioned CG run simultaneously on all m
right-hand sides (per-vector step lengths), entirely under ``jit`` with
``lax.while_loop``. Inverse iteration tolerates inexact inverse applications,
so ``rtol`` can be far looser than the eigensolver tolerance.

``cg_solve_t`` is the hot-path form: it operates on the TRANSPOSED (m, n*)
multivector — including the guarded persistent layout, whose zero guard
columns pass through every axpy/dot untouched (the Jacobi diagonal is
guarded with ones so elementwise divisions stay finite) — so every inner
SpMM runs the guarded-layout DIA kernel. The factory is marked
``internal`` and its solve fn ``layout_t`` (see solvers/engine.py).

The level-scheduled direct solve (host_lu.py) remains available as the
correctness-spec alternative.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from dune_eigensolver_tpu.sparse.spmm import spmm_t


def cg_solve_t(
    apply_a: Callable,
    B: jax.Array,
    inv_diag: Optional[jax.Array] = None,
    rtol: float = 1e-6,
    maxiter: int = 1000,
    gram_reduce: Optional[Callable] = None,
    x0: Optional[jax.Array] = None,
    precond_apply: Optional[Callable] = None,
):
    """Solve ``A X = B`` for SPD A, all rows of the transposed multivector
    simultaneously. B: (m, n*).

    apply_a: Xt -> (A @ X)^T. inv_diag: (n*,) reciprocal diagonal of A for
    Jacobi preconditioning (guard positions must hold a finite filler —
    their residuals are zero so the value is irrelevant).
    precond_apply: R -> M^-1 R, a FIXED SPD preconditioner application
    (e.g. a Chebyshev polynomial of A); overrides the Jacobi default.
    gram_reduce: allreduce for sharded operands (dots become psums).
    Returns (X, iterations).
    """
    reduce_ = gram_reduce or (lambda g: g)

    if precond_apply is not None:
        precond = precond_apply
    else:

        def precond(R):
            return R if inv_diag is None else R * inv_diag[None, :]

    acc_dt = jnp.promote_types(B.dtype, jnp.float32)  # bf16 -> f32, f64 stays

    def rowdot(U, V):
        # accumulate at >= f32 regardless of the streamed dtype: with a
        # bf16 iterate (dtype= on the factory) a 10M-element bf16 sum would
        # lose the residual norm entirely; the upcast fuses into the
        # product read, costing no extra HBM traffic
        return reduce_(jnp.sum((U * V).astype(acc_dt), axis=1))

    X = jnp.zeros_like(B) if x0 is None else x0
    R = B - apply_a(X) if x0 is not None else B
    Z = precond(R)
    P = Z
    rz = rowdot(R, Z)
    bnorm = jnp.sqrt(rowdot(B, B))
    # rows with zero rhs are converged by definition
    target = rtol * jnp.where(bnorm > 0, bnorm, 1.0)

    def cond(state):
        X, R, P, rz, k = state
        rnorm = jnp.sqrt(rowdot(R, R))
        return (k < maxiter) & jnp.any(rnorm > target)

    def body(state):
        X, R, P, rz, k = state
        AP = apply_a(P)
        pap = rowdot(P, AP)
        alpha = jnp.where(pap > 0, rz / jnp.where(pap > 0, pap, 1.0), 0.0)
        # step lengths are f32 (rowdot); cast at use so a bf16 iterate
        # stays bf16 instead of silently promoting every axpy to f32
        X = X + P * alpha.astype(X.dtype)[:, None]
        R = R - AP * alpha.astype(X.dtype)[:, None]
        Z = precond(R)
        rz_new = rowdot(R, Z)
        beta = jnp.where(rz > 0, rz_new / jnp.where(rz > 0, rz, 1.0), 0.0)
        P = Z + P * beta.astype(X.dtype)[:, None]
        return X, R, P, rz_new, k + 1

    X, R, P, rz, k = lax.while_loop(
        cond, body, (X, R, P, rz, jnp.zeros((), jnp.int32))
    )
    return X, k


def cg_solve(
    apply_a: Callable,
    B: jax.Array,
    diag: Optional[jax.Array] = None,
    rtol: float = 1e-6,
    maxiter: int = 1000,
    gram_reduce: Optional[Callable] = None,
    x0: Optional[jax.Array] = None,
):
    """Column-layout wrapper over ``cg_solve_t``: B (n, m), apply_a on
    (n, m)."""
    apply_a_t = lambda Xt: apply_a(Xt.T).T  # noqa: E731
    inv_diag = None if diag is None else 1.0 / diag
    X, k = cg_solve_t(
        apply_a_t,
        B.T,
        inv_diag=inv_diag,
        rtol=rtol,
        maxiter=maxiter,
        gram_reduce=gram_reduce,
        x0=None if x0 is None else x0.T,
    )
    return X.T, k


def _inv_diag_of(A_int):
    """Guard-safe reciprocal diagonal of an internal operand."""
    if hasattr(A_int, "padded_diagonal"):  # PaddedDIA / Windowed{ELL,BSR}
        return 1.0 / A_int.padded_diagonal(fill=1.0)
    if hasattr(A_int, "diagonal"):
        return 1.0 / A_int.diagonal()
    return None


def cg_inverse_factory(
    rtol: float = 1e-6,
    maxiter: int = 1000,
    gram_reduce: Optional[Callable] = None,
    apply_a: Optional[Callable] = None,
    dtype=None,
):
    """Factory of factories: returns an ``inverse=`` argument for the solvers.

    ``inverse(A_int)`` yields a jittable transposed-layout solve (marked
    ``layout_t``); the factory itself is marked ``internal`` so the solver
    wrappers hand it the guarded operand and the inner SpMMs run the DIA
    kernel. ``apply_a`` overrides the operator application (e.g. a sharded
    SpMM closing over local shards inside shard_map; transposed layout).

    ``dtype``: run the ENTIRE inner CG (operand stream, iterate, axpys) in
    this dtype, casting in/out at the boundary — dots still accumulate in
    f32 (cg_solve_t). ``jnp.bfloat16`` halves the preconditioner's HBM
    traffic, which dominates LOBPCG iterations at large n; the returned
    direction is preconditioner-grade (~2 decimal digits), so use it only
    where the inverse is applied approximately (LOBPCG precond), never for
    shift-invert subspace iteration's inexact-but-converging inner solve.
    """

    def inverse(A_int):
        if apply_a is not None:
            # caller-supplied operator (e.g. sharded SpMM): plain-callable
            # convention, diag from the operand if one is given
            inv_diag = _inv_diag_of(A_int) if A_int is not None else None

            def solve(Xt):
                Y, _ = cg_solve_t(
                    apply_a, Xt, inv_diag=inv_diag, rtol=rtol, maxiter=maxiter,
                    gram_reduce=gram_reduce,
                )
                return Y

            solve.layout_t = True
            return solve

        # closure-free pair: the operand is threaded through jit as an
        # argument (a closure would embed it as a constant in every trace),
        # and the solve fn is memoized so the solver cores' jit caches
        # (keyed on the fn's identity) hit across factory calls
        return (
            (A_int, _inv_diag_of(A_int)),
            _cg_solve_fn(rtol, maxiter, gram_reduce, dtype),
        )

    inverse.internal = True
    return inverse


_CG_SOLVE_FNS = {}


def _cast_floating(tree, dt):
    return jax.tree_util.tree_map(
        lambda x: x.astype(dt)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x,
        tree,
    )


def _cg_solve_fn(rtol, maxiter, gram_reduce, dtype=None):
    key = (
        float(rtol),
        int(maxiter),
        id(gram_reduce) if gram_reduce else None,
        None if dtype is None else jnp.dtype(dtype).name,
    )
    if key not in _CG_SOLVE_FNS:

        def solve_pair(aux, Xt, _rtol=rtol, _maxiter=maxiter, _gr=gram_reduce):
            A_, d_ = aux
            out_dt = Xt.dtype
            if dtype is not None:
                # cast INSIDE jit: aux stays the solver's f32 operand (one
                # shared buffer); the bf16 copy is one fused pass per solve
                A_, d_, Xt = (
                    _cast_floating(A_, dtype),
                    None if d_ is None else d_.astype(dtype),
                    Xt.astype(dtype),
                )
            Y, _ = cg_solve_t(
                lambda V: spmm_t(A_, V), Xt, inv_diag=d_, rtol=_rtol,
                maxiter=_maxiter, gram_reduce=_gr,
            )
            return Y.astype(out_dt)

        solve_pair.layout_t = True
        _CG_SOLVE_FNS[key] = solve_pair
    return _CG_SOLVE_FNS[key]
