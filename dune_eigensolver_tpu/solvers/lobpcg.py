"""LOBPCG: locally-optimal block preconditioned conjugate gradient.

An *addition* beyond the reference's solver set: the reference
computes the smallest eigenpairs of ``A x = lambda B x`` by shift-invert
subspace iteration (``GeneralizedInverse``, dune/eigensolver/
eigensolver.hh:204-351), which applies a full direct solve every iteration
and converges at the subspace-iteration rate. LOBPCG (Knyazev 2001) reaches
the same eigenpairs with a three-term locally-optimal subspace
``[X, T r, P]`` and typically fewer operator applications; every step is
tall-skinny dense algebra (Gram matrices, small eigh, block rotations) that
maps straight onto dense matmuls, plus one SpMM per operator. The shifted direct
factorization the reference builds anyway (our block-banded partitioned
inverse) slots in as the preconditioner ``T ~ (A + shift*B)^-1``.

Formulation note (why the *reciprocal* pencil): the GenEO mass matrix B is
positive **semi**-definite (partition-of-unity masked, zero near the
boundary — src/dune-eigensolver.cc:124-143), so minimizing the Rayleigh
quotient x^T A x / x^T B x directly is numerically treacherous: directions
with vanishing B-mass have 0/0 quotients and stall or poison the Ritz step.
Instead we use that A' = A + shift*B is positive definite (the same
assumption the reference's factorization makes, eigensolver.hh:241-256) and
seek the LARGEST eigenvalues nu of the reciprocal pencil

    B y = nu A' y,    nu = 1 / (lambda + shift),

with an A'-orthonormal basis. B-null junk directions then sit harmlessly at
nu ~ 0, the opposite end of the spectrum from what Rayleigh-Ritz selects.

The iteration state is the TRANSPOSED multivector (m, n*), guarded for the
DIA kernel on DIA operands (solvers/engine.py); the
search block [X; W; P] is a (3m, n*) stack of rows. Structure mirrors the
other solvers: a module-level jitted core with all large operands as
explicit arguments, and ``apply_a``/``apply_b``/``gram_reduce`` hooks for
the distributed layer.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from dune_eigensolver_tpu.ops.ortho import b_orthonormalize_blocked_t
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

_PREC = lax.Precision.HIGHEST


def _identity_apply(X):
    """apply_b for an identity mass matrix (``b_identity=True``): the hook is
    module-level so the jitted core's static hooks key stays stable."""
    return X


def _lobpcg_core(A_int, B_int, prec_aux, Q0, hooks, cfg):
    apply_a_h, apply_b_h, gram_reduce, prec_fn = hooks
    (nev, tol, maxiter, shift_eval, block, min_iter, ortho_eps, n, dtype,
     ortho_iters, ortho_block) = cfg
    apply_a = apply_a_h or (lambda X: spmm_t(A_int, X))
    apply_b = apply_b_h or (lambda X: spmm_t(B_int, X))
    reduce_ = gram_reduce or (lambda g: g)
    shift_ = jnp.asarray(shift_eval, dtype)
    m = Q0.shape[0]
    spec = _spec_of(A_int)
    tiny = jnp.asarray(1e-30, dtype)

    def a_ortho(S):
        # CholeskyQR in the A'-inner product; A' is PD so no junk handling
        # is needed (the eps floor only guards W -> 0 at convergence).
        # ortho_block='full' = whole-basis CholeskyQR: one Gram + one
        # trisolve instead of a prefix sweep whose every step re-reads the
        # full (3m, n*) buffer — but the full-width f32 Gram
        # has cond(S)^2 and NaNs on ill-conditioned bases (loose-CG GenEO),
        # so the robust b-blocked sweep stays the default.
        if ortho_block == "full":
            blk = S.shape[0]
        else:
            # clamp: the iteration-0 ortho sees the (m, n*) start block,
            # the loop the (3m, n*) search basis
            blk = min(ortho_block or block, S.shape[0])
        S, _ = b_orthonormalize_blocked_t(
            apply_a, S, block=blk,
            gram_reduce=gram_reduce, iterations=ortho_iters, eps=ortho_eps,
        )
        return S

    def ritz(S, k):
        """Rayleigh-Ritz for the largest-k of ``B y = nu A' y`` on an
        A'-orthonormal basis S: returns (nu, V) with nu descending."""
        BS = apply_b(S)
        G = reduce_(jnp.dot(BS, S.T, precision=_PREC))
        G = 0.5 * (G + G.T)
        nu, V = jnp.linalg.eigh(G)  # ascending
        return nu[::-1][:k], V[:, ::-1][:, :k]

    def lam_of(nu):
        return 1.0 / jnp.maximum(nu, tiny) - shift_

    # --- iteration 0: Rayleigh-Ritz on the start block alone ---
    X = a_ortho(Q0)
    nu, V = ritz(X, m)
    X = jnp.dot(V.T, X, precision=_PREC)
    lam = lam_of(nu)
    P = jnp.zeros_like(X)
    have_p = jnp.zeros((), jnp.bool_)

    def body(state):
        X, P, have_p, lam_prev, it, _ = state
        AX = apply_a(X)
        BX = apply_b(X)
        nu = reduce_(jnp.sum(X * BX, axis=1))  # X is A'-orthonormal
        R = BX - AX * nu[:, None]
        W = prec_fn(prec_aux, R)
        # Row-normalize the preconditioned residuals (scipy.lobpcg does the
        # same): per-pair convergence differs by orders of magnitude — with
        # a nested-iteration seed (q0 from a coarser grid) the spread is
        # extreme from iteration 1 — and the blocked CholeskyQR's Gram sees
        # the SQUARE of that dynamic range, which NaN'd the f32 Cholesky at
        # n=10M. Scaling rows leaves the search span unchanged; zero rows
        # stay zero and fall through to the ortho's eps floor as before.
        wn = reduce_(jnp.sum(W * W, axis=1))
        W = W / jnp.sqrt(jnp.maximum(wn, tiny))[:, None]
        # P is zero on the first pass; the filler is projected to noise by
        # the orthonormalization (eps floor) and never selected by RR.
        P_eff = jnp.where(have_p, P, W * 0.5)
        S = jnp.concatenate([X, W, P_eff], axis=0)  # (3m, n*)
        S = a_ortho(S)
        nu_all, Vx = ritz(S, m)
        Xn = jnp.dot(Vx.T, S, precision=_PREC)
        # LOBPCG direction: the Ritz rotation restricted to the [W, P] block
        Vp = Vx.at[:m, :].set(0.0)
        Pn = jnp.dot(Vp.T, S, precision=_PREC)
        # A'-normalize P rows (guard against zero rows)
        APn = apply_a(Pn)
        pn = reduce_(jnp.sum(Pn * APn, axis=1))
        Pn = Pn / jnp.sqrt(jnp.maximum(pn, tiny))[:, None]
        lam_n = lam_of(nu_all)
        relerror = jnp.max(jnp.abs(lam_n - lam_prev)) / jnp.maximum(
            jnp.max(jnp.abs(lam_n)), tiny
        )
        return Xn, Pn, jnp.ones((), jnp.bool_), lam_n, it + 1, relerror

    def cond(state):
        _, _, _, _, it, relerror = state
        return (it < maxiter) & ((it <= min_iter) | (relerror >= tol))

    state = (X, P, have_p, lam, jnp.zeros((), jnp.int32), jnp.asarray(jnp.inf, dtype))
    X, P, _, lam, it, relerror = lax.while_loop(cond, body, state)
    # X rows are A'-orthonormal; rescale to B-normalized eigenvectors the
    # way the reference returns them (unit B-norm up to convergence).
    BX = apply_b(X)
    bmass = reduce_(jnp.sum(X * BX, axis=1))
    X = X / jnp.sqrt(jnp.maximum(bmass, tiny))[:, None]
    evals, evecs_t = sort_result_t(lam, X, nev, descending=False)
    return EigenResult(
        eigenvalues=evals,
        eigenvectors=from_internal_vectors(evecs_t, spec, n),
        iterations=it,
        converged=relerror < tol,
        criterion=relerror,
        ortho_monitor=jnp.zeros((), dtype),
    )


_lobpcg_core_jit = jax.jit(_lobpcg_core, static_argnums=(4, 5))


def lobpcg_generalized(
    A,
    B,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    reg: float = 0.0,
    block: int = 8,
    seed: int = 123,
    min_iter: int = 3,
    ortho_eps: float = 1e-9,
    ortho_iterations: int = 2,
    ortho_block: Optional[int] = None,
    b_identity: bool = False,
    precond: Optional[Callable] = None,
    apply_a: Optional[Callable] = None,
    apply_b: Optional[Callable] = None,
    gram_reduce: Optional[Callable] = None,
    q0: Optional[jax.Array] = None,
    eval_shift: Optional[float] = None,
    dtype=None,
    force_padded: Optional[bool] = None,
) -> EigenResult:
    """Smallest-nev eigenpairs of ``A x = lambda B x`` by preconditioned
    LOBPCG on the reciprocal pencil (module docstring). Same problem and
    operand contract as ``generalized_inverse`` (reference
    eigensolver.hh:204-351) with typically fewer operator applications.

    Requires A' = A + shift*B + reg*I positive definite — the same
    assumption the reference's no-pivot factorization path makes; pass a
    positive ``shift`` (reference default 1e-3) and/or ``reg``.

    ``ortho_iterations``: CholeskyQR passes per basis orthonormalization
    (default 2 = CholeskyQR2, the safe f32 choice). 1 saves one operator
    application on the (3m, n*) search block per ortho — worthwhile at very
    large n when the preconditioner keeps the basis well conditioned;
    validate against an oracle before relying on it.

    ``ortho_block``: column-block size of the basis orthonormalization sweep.
    Default ``None`` = ``block`` (the reference's b-blocked prefix sweep,
    robust for ill-conditioned bases). ``'full'`` = whole-basis CholeskyQR —
    one Gram + one trisolve, ~6x less HBM traffic at large n, valid when the
    preconditioner keeps the basis well conditioned (e.g. the MG-V-cycle
    north-star recipe; full-width f32 Cholesky sees cond(S)^2 and NaNs on
    loose-CG GenEO bases — validate against an oracle before relying on it).

    ``b_identity=True`` asserts B is the identity (the standard-problem
    embedding, e.g. the 3D north-star pencil): ``B @ X`` becomes a no-op,
    removing three full passes over the search block per iteration. The
    caller owns the assertion — it is not checked against ``B``'s values
    (that would cost a device fetch at setup; ``ev.paranoid=1`` checks it,
    utils/paranoid.py).

    ``precond``: factory mapping A' to an (approximate) inverse apply; same
    conventions as the ``inverse=`` factories (plain callable or
    closure-free ``(aux, fn)``; ``internal``-marked factories receive the
    guarded operand and run the fast SpMM in their inner loop). Defaults to
    ``factorize.default_inverse_factory`` — the same engine the shift-invert
    solvers use, here only needed approximately. Pass ``precond=False`` for
    unpreconditioned LOBPCG (matrix-free end to end).
    """
    from dune_eigensolver_tpu.solvers.standard import shifted_operand

    dtype = dtype or A.dtype
    m = padded_width(nev, block)
    n = A.shape[0]
    dist_mode = apply_a is not None and apply_b is not None
    if dist_mode:
        A_int = B_int = None
        layout = None
        if precond is False:
            prec_aux, prec_fn = None, (lambda _aux, X: X)
        else:
            prec_aux, prec_fn = normalize_inverse(precond(None))
    else:
        from dune_eigensolver_tpu.solvers.engine import memoized_setup

        if precond is None:
            from dune_eigensolver_tpu.factorize import default_inverse_factory

            precond = default_inverse_factory

        def _build():
            # m_max: the search block is (3m, n*) — size the layout for it
            A_sh = shifted_operand(A, B, shift, reg)
            A_int, B_int, layout, _spec = make_engine(
                A_sh, B, 3 * m, force_padded
            )
            if precond is False:
                aux, fn = None, (lambda _aux, X: X)
            else:
                if getattr(precond, "internal", False):
                    aux, fn = normalize_inverse(precond(A_int))
                else:
                    aux, fn = normalize_inverse(precond(A_sh))
                aux, fn = adapt_inverse(aux, fn, layout)
            return A_int, B_int, layout, aux, fn

        # setup memoized on operand identities (see generalized_inverse):
        # repeated solves on one pencil pay planning/factorization once
        objs = (A,) if precond is False else (A, precond)
        A_int, B_int, layout, prec_aux, prec_fn = memoized_setup(
            objs if B is None else objs + (B,),
            ("lobpcg", float(shift), float(reg), 3 * m, force_padded),
            _build,
        )
    hooked = dist_mode or gram_reduce is not None
    if q0 is not None:
        Q0 = q0 if hooked else to_internal(q0.T, layout)
    else:
        Q0 = to_internal(
            random_multivector_t(jax.random.PRNGKey(seed), n, m, dtype), layout
        )
    if b_identity and apply_b is None:
        # opt-in device-side verification of the caller's assertion
        # (ev.paranoid=1 / set_paranoid(True)); no-op otherwise
        from dune_eigensolver_tpu.utils.paranoid import b_identity_check

        b_identity_check(B if not dist_mode else None)
        apply_b = _identity_apply
    cfg = (
        nev,
        float(tol),
        int(maxiter),
        float(shift if eval_shift is None else eval_shift),
        int(block),
        int(min_iter),
        float(ortho_eps),
        int(n),
        jnp.dtype(dtype),
        int(ortho_iterations),
        ortho_block if ortho_block in (None, "full") else int(ortho_block),
    )
    hooks = (apply_a, apply_b, gram_reduce, prec_fn)
    if (
        apply_a is None
        and (apply_b is None or apply_b is _identity_apply)
        and gram_reduce is None
    ):
        return _lobpcg_core_jit(A_int, B_int, prec_aux, Q0, hooks, cfg)
    return _lobpcg_core(A_int, B_int, prec_aux, Q0, hooks, cfg)
