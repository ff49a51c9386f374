"""Chebyshev polynomial inverse application (preconditioner engine).

The reference applies exact inverses through UMFPACK factors
(umfpacktools.hh:16-220, kernels_cpp.hh:660-755). On the device the
matrix-free alternatives are Jacobi-CG (factorize/cg.py) and this module: a fixed-degree
Chebyshev approximation of ``A^-1`` on a spectral interval. Per degree it
costs one SpMM plus three axpys — and, unlike CG, **zero inner dot
products**, so there are no full-array reduction passes and no
data-dependent control flow: the whole application is one statically
unrolled ``fori_loop`` that XLA fuses aggressively. That makes it the
preferred LOBPCG preconditioner on bandwidth-bound problems (the 10M-dof 3D
Laplacian run spends most of its memory traffic inside the preconditioner).

Operates natively on the TRANSPOSED (m, n*) multivector (guarded layout
included), so every SpMM inside the polynomial runs the guarded-layout
kernel; the factory is marked ``internal`` (solvers/engine.py)
and receives the guarded operand from the solver wrappers.

Spectral bounds come from one device-side blocked power iteration on the
Jacobi-scaled operator ``D^-1 A`` (run once at factory time, jitted, operand
as an argument). The smoothing interval is ``[lmax/cond_target, lmax]``:
Chebyshev error on the interval decays like ((sqrt(k)-1)/(sqrt(k)+1))^deg
with k = cond_target, so degree 16 at k=30 ~ 3e-3 — comparable to the
rtol=1e-2 loose-CG preconditioner at roughly half the memory traffic.

The operator ``p(D^-1 A) D^-1`` is SPD whenever p > 0 on the spectrum
(equals ``D^-1/2 p(D^-1/2 A D^-1/2) D^-1/2``), as LOBPCG requires.

Conventions match cg.py: factories return closure-free ``(aux, fn)`` pairs
with module-level memoized fns (solver jit caches key on fn identity — see
CLAUDE.md architecture invariants).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from dune_eigensolver_tpu.factorize.cg import _inv_diag_of
from dune_eigensolver_tpu.sparse.spmm import spmm_t


def _internal_width(A_int) -> int:
    """Internal row width of an operand: the guarded layout's width for a
    PaddedDIA, the row count n for every plain container (DIA, ELL, BSR)."""
    from dune_eigensolver_tpu.kernels.dia_spmm import PaddedDIA

    if isinstance(A_int, PaddedDIA):
        return A_int.data.shape[1]
    return A_int.shape[0]


def _power_lmax_t(apply_a, inv_diag, n_int, dtype, iters, gram_reduce, fold=None):
    """Largest eigenvalue of ``D^-1 A`` by blocked power iteration
    (device-side, transposed layout: an 8-row block costs about as much as
    one vector and is far more robust to an unlucky start).

    Random N(0,1) start: the top mode of diffusion-type operators is highly
    oscillatory, and a smooth deterministic start is nearly orthogonal to it
    — power iteration would then underestimate lmax badly, which is the one
    failure that can hurt (see chebyshev_apply). ``fold`` (e.g. the shard
    index from lax.axis_index) de-periodizes the start across shards — a
    shard-periodic global start is structured, not i.i.d."""
    reduce_ = gram_reduce or (lambda g: g)
    key = jax.random.PRNGKey(42)
    if fold is not None:
        key = jax.random.fold_in(key, fold)
    v = jax.random.normal(key, (8, n_int), dtype)

    def mat(u):
        w = apply_a(u)
        return w if inv_diag is None else w * inv_diag[None, :]

    def body(_, v):
        w = mat(v)
        nrm = jnp.sqrt(reduce_(jnp.sum(w * w, axis=1)))
        return w / jnp.maximum(nrm, 1e-30)[:, None]

    v = lax.fori_loop(0, iters, body, v)
    w = mat(v)
    num = reduce_(jnp.sum(v * w, axis=1))
    den = reduce_(jnp.sum(v * v, axis=1))
    return jnp.max(num / jnp.maximum(den, 1e-30))


def chebyshev_apply_t(apply_a, R, lmin, lmax, degree, inv_diag=None):
    """W ~ A^-1 R via degree-``degree`` Chebyshev iteration on [lmin, lmax]
    (eigen-bounds of ``D^-1 A`` when ``inv_diag`` is given, of A otherwise).
    Transposed layout R (m, n*); zero dot products; static trip count.

    ``degree`` is rounded up to ODD. The applied polynomial
    p(x) = (1 - r(x))/x with residual r(x) = T_d(sigma(x))/T_d(sigma1) is
    positive on (0, lmax] for any d, but for x > lmax the sign of T_d flips
    with the parity of d: even d makes p negative above lmax, so an
    underestimated lmax (power iteration on a clustered top) silently turns
    the preconditioner indefinite and LOBPCG locks onto the wrong end of the
    spectrum. Odd d keeps p > 0 on all of (0, inf) — SPD unconditionally.
    """
    degree = int(degree) | 1  # round up to odd (see docstring)
    prec = (lambda V: V) if inv_diag is None else (lambda V: V * inv_diag[None, :])
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rho0 = 1.0 / sigma1

    # the rho recurrence stays in the scalars' own (f32) precision; cast
    # only at the array multiply so a bf16 iterate is not silently promoted
    # back to f32 (which would both break the fori_loop carry dtype and
    # forfeit the halved memory traffic the caller asked for)
    def _c(s):
        return jnp.asarray(s).astype(R.dtype)

    x = jnp.zeros_like(R)
    r = R
    d = prec(r) * _c(1.0 / theta)

    def body(_, state):
        x, r, d, rho = state
        x = x + d
        r = r - apply_a(d)
        rho_next = 1.0 / (2.0 * sigma1 - rho)
        d = _c(rho_next * rho) * d + _c(2.0 * rho_next / delta) * prec(r)
        return x, r, d, rho_next

    x, _, _, _ = lax.fori_loop(0, degree, body, (x, r, d, rho0))
    return x


def chebyshev_apply(apply_a, R, lmin, lmax, degree, inv_diag=None):
    """Column-layout wrapper over ``chebyshev_apply_t`` (R (n, m), inv_diag
    (n,) reciprocal diagonal)."""
    apply_a_t = lambda Xt: apply_a(Xt.T).T  # noqa: E731
    return chebyshev_apply_t(apply_a_t, R.T, lmin, lmax, degree, inv_diag).T


def chebyshev_inverse_factory(
    degree: int = 17,
    cond_target: float = 30.0,
    lmax_scale: float = 1.1,
    power_iters: int = 40,
    jacobi: bool = True,
    gram_reduce: Optional[Callable] = None,
    apply_a: Optional[Callable] = None,
    fold=None,
    dtype=None,
):
    """Factory of factories (same contract as ``cg_inverse_factory``):
    ``inverse(A_int)`` yields the Chebyshev approximate inverse of A_int
    (transposed layout, marked ``layout_t``; the factory is ``internal``).

    degree: polynomial degree (SpMMs per application, static). Values <= 0
        are rejected; even values are rounded up to odd (SPD-safety).
    cond_target: lmin = lmax / cond_target — how deep into the low spectrum
        the polynomial stays accurate. Must be > 1 (lmin < lmax). Larger =
        better preconditioner per application, slower per-degree decay.
    jacobi: scale by D^-1 (recommended; bounds then live on D^-1 A).
    apply_a / gram_reduce: distributed hooks (sharded SpMM / psum,
    transposed layout).
    dtype: stream the polynomial recurrence in this dtype (casting in/out
    at the boundary) — ``jnp.bfloat16`` halves the memory traffic of every
    SpMM+axpy term; preconditioner-grade, same caveats as
    ``cg_inverse_factory(dtype=...)``. Single-chip pair path only.
    """
    if not cond_target > 1.0:
        raise ValueError(f"chebyshev: cond_target must be > 1, got {cond_target}")
    if int(degree) < 1:
        raise ValueError(f"chebyshev: degree must be >= 1, got {degree}")

    def inverse(A_int):
        if apply_a is not None:
            # caller-supplied operator (e.g. sharded SpMM inside shard_map):
            # plain-callable convention, bounds estimated through the hook
            inv_diag = (
                _inv_diag_of(A_int) if (jacobi and A_int is not None) else None
            )
            n_int = _internal_width(A_int)
            lmax = (
                _power_lmax_t(
                    apply_a, inv_diag, n_int, A_int.dtype, power_iters,
                    gram_reduce, fold=fold,
                )
                * lmax_scale
            )
            lmin = lmax / cond_target

            def solve(Xt):
                return chebyshev_apply_t(apply_a, Xt, lmin, lmax, degree, inv_diag)

            solve.layout_t = True
            return solve

        # closure-free pair: operand + Jacobi diagonal + spectral bounds are
        # aux (threaded through jit as arguments); the solve fn is memoized
        # on the static config so solver jit caches hit across factory calls
        inv_diag = _inv_diag_of(A_int) if jacobi else None
        lmax = _estimate_lmax_jit(A_int, inv_diag, int(power_iters)) * lmax_scale
        lmin = lmax / cond_target
        aux = (A_int, inv_diag, lmin, lmax)
        return aux, _cheb_solve_fn(int(degree), bool(jacobi), dtype)

    inverse.internal = True
    return inverse


def _estimate_lmax_jit(A_int, inv_diag, iters):
    # iters as a traced scalar would retrace fori_loop bounds; pass as a
    # Python int bound into fori_loop via closure — memoize per iters value
    return _ESTIMATE_FNS.setdefault(
        iters,
        jax.jit(
            lambda A_, d_, _it=iters: _power_lmax_t(
                lambda V: spmm_t(A_, V),
                d_,
                _internal_width(A_),
                A_.dtype,
                _it,
                None,
            )
        ),
    )(A_int, inv_diag)


def cheb_cg_inverse_factory(
    degree: int = 7,
    cond_target: float = 30.0,
    rtol: float = 1e-5,
    maxiter: int = 200,
    lmax_scale: float = 1.1,
    power_iters: int = 40,
    gram_reduce: Optional[Callable] = None,
    apply_a: Optional[Callable] = None,
    fold=None,
):
    """Chebyshev-preconditioned CG inverse — the wide-band (3D) default.

    Pure Jacobi-CG needs O(sqrt(kappa)) dot-product-bearing iterations; with
    a fixed degree-d Chebyshev polynomial of ``D^-1 A`` as the CG
    preconditioner the outer iteration count drops by ~d while each outer
    step stays dot-free inside the polynomial — far fewer full-array
    reduction passes on a bandwidth-bound operator (the preconditioner
    dominates memory traffic on the 10M-dof 3D run). The polynomial is FIXED
    (constant bounds, odd degree -> SPD), as CG requires of its
    preconditioner. Same (aux, memoized-fn) conventions as the other
    factories; replaces the reference's exact UMFPACK inverse
    (umfpacktools.hh:16-220) in the regime where direct factors fill
    (3D, kernels_cpp.hh:660-755 has no answer there either).
    """
    if not cond_target > 1.0:
        raise ValueError(f"cheb_cg: cond_target must be > 1, got {cond_target}")
    if int(degree) < 1:
        raise ValueError(f"cheb_cg: degree must be >= 1, got {degree}")

    def inverse(A_int):
        if apply_a is not None:
            # sharded path: operator through the hook, dots through psum
            inv_diag = _inv_diag_of(A_int) if A_int is not None else None
            n_int = _internal_width(A_int)
            lmax = (
                _power_lmax_t(
                    apply_a, inv_diag, n_int, A_int.dtype, power_iters,
                    gram_reduce, fold=fold,
                )
                * lmax_scale
            )
            lmin = lmax / cond_target

            def solve(Xt):
                Y, _ = _cg_cheb_run(
                    apply_a, Xt, inv_diag, lmin, lmax, int(degree),
                    rtol, maxiter, gram_reduce,
                )
                return Y

            solve.layout_t = True
            return solve

        inv_diag = _inv_diag_of(A_int)
        lmax = _estimate_lmax_jit(A_int, inv_diag, int(power_iters)) * lmax_scale
        lmin = lmax / cond_target
        aux = (A_int, inv_diag, lmin, lmax)
        return aux, _cheb_cg_solve_fn(int(degree), float(rtol), int(maxiter))

    inverse.internal = True
    return inverse


def _cg_cheb_run(apply_a, Xt, inv_diag, lmin, lmax, degree, rtol, maxiter, gr):
    from dune_eigensolver_tpu.factorize.cg import cg_solve_t

    precond = lambda R: chebyshev_apply_t(  # noqa: E731
        apply_a, R, lmin, lmax, degree, inv_diag
    )
    return cg_solve_t(
        apply_a, Xt, rtol=rtol, maxiter=maxiter, gram_reduce=gr,
        precond_apply=precond,
    )


_ESTIMATE_FNS = {}
_CHEB_SOLVE_FNS = {}
_CHEB_CG_SOLVE_FNS = {}


def _cheb_cg_solve_fn(degree, rtol, maxiter):
    key = (degree, rtol, maxiter)
    if key not in _CHEB_CG_SOLVE_FNS:

        def solve_pair(aux, Xt, _deg=degree, _rtol=rtol, _mx=maxiter):
            A_, inv_diag, lmin, lmax = aux
            Y, _ = _cg_cheb_run(
                lambda V: spmm_t(A_, V), Xt, inv_diag, lmin, lmax, _deg,
                _rtol, _mx, None,
            )
            return Y

        solve_pair.layout_t = True
        _CHEB_CG_SOLVE_FNS[key] = solve_pair
    return _CHEB_CG_SOLVE_FNS[key]


def _cheb_solve_fn(degree, jacobi, dtype=None):
    key = (degree, jacobi, None if dtype is None else jnp.dtype(dtype).name)
    if key not in _CHEB_SOLVE_FNS:

        def solve_pair(aux, Xt, _deg=degree):
            A_, inv_diag, lmin, lmax = aux
            out_dt = Xt.dtype
            if dtype is not None:
                from dune_eigensolver_tpu.factorize.cg import _cast_floating

                A_ = _cast_floating(A_, dtype)
                inv_diag = None if inv_diag is None else inv_diag.astype(dtype)
                Xt = Xt.astype(dtype)
            Y = chebyshev_apply_t(
                lambda V: spmm_t(A_, V), Xt, lmin, lmax, _deg, inv_diag
            )
            return Y.astype(out_dt)

        solve_pair.layout_t = True
        _CHEB_SOLVE_FNS[key] = solve_pair
    return _CHEB_SOLVE_FNS[key]
