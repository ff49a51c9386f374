"""Geometric multigrid V-cycle for structured-stencil DIA operators.

An *addition* beyond the reference's inverse engines: the reference
applies ``A'^-1`` through UMFPACK LU (dune/eigensolver/umfpacktools.hh:16-220)
whose fill is catastrophic for 3D stencils, and this repo's wide-band default
so far was Chebyshev/Jacobi-CG (factorize/cg.py, factorize/chebyshev.py) —
an O(sqrt(kappa)) iteration. For the constant-coefficient Dirichlet stencils
of the reference driver (src/dune-eigensolver.cc:98-156 2D; the 3D north-star
operator, problems.laplacian_dirichlet_3d) a rediscretized geometric V-cycle
is spectrally equivalent to A'^-1 *independently of n*, so one cycle replaces
tens of CG iterations per preconditioner application.

Design (all shapes static, everything under ``jit``):

* grid detection is purely structural: offsets ``{0, +-1, +-Nx[, +-Nx*Ny]}``
  with matching ``n`` give dims ``(Ny, Nx)`` / ``(Nz, Ny, Nx)`` (the +-1
  offset is the fastest axis). Stencil coefficients are sampled IN-TRACE from
  an interior row of the operand — setup performs no host fetch and the
  factory stays closure-free.
* level l operator: the same stencil with each axis coupling scaled by
  4^-l and the zeroth-order term sigma = c0 + 2*sum(a_ax) held fixed —
  for linear interpolation P and full-weighting R = 2^-d P^T this *is* the
  1D Galerkin operator and the standard rediscretization in 2D/3D. Applied
  matrix-free as shifted adds on the (m, *dims) block — coarse work is a
  geometric tail (<= 1/7 of fine in 3D) so XLA formulations suffice there.
* fine level smooths with the actual operand through ``spmm_t`` — on the
  GPU the guarded-layout DIA kernel (kernels/dia_spmm.py), the same hot
  path as the solver cores; the multivector stays in the guarded layout and
  only the restricted residual is sliced to logical + reshaped to the grid.
* smoother: damped Jacobi (symmetric pre/post, so the cycle is SPD and safe
  inside CG and LOBPCG); coarsest level: fixed-iteration CG in f32.
* ``dtype=jnp.bfloat16`` streams the fine-level smoothing in bf16 (the same
  trade as ``cg_inverse_factory(dtype=...)``: preconditioner-grade output
  for half the HBM traffic).

Factories follow the closure-free (aux, fn) contract (CLAUDE.md invariants):
``aux = (A_int, inv_diag)`` threads through jit as arguments; solve fns are
memoized on static geometry so solver jit caches stay warm.

``mg_inverse_factory``   -- V-cycle(s) as a preconditioner (LOBPCG).
``mg_cg_inverse_factory``-- V-cycle-preconditioned CG to a tolerance: the
                            wide-band shift-invert engine (subspace iteration
                            needs a converging inner solve, eigensolver.hh:
                            261-310 applies the factorized inverse there).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from dune_eigensolver_tpu.factorize.cg import _cast_floating, cg_solve_t
from dune_eigensolver_tpu.kernels.dia_spmm import PaddedDIA
from dune_eigensolver_tpu.sparse.formats import DIAMatrix
from dune_eigensolver_tpu.sparse.spmm import spmm_t


def detect_grid_dims(offsets, n: int) -> Optional[Tuple[int, ...]]:
    """Structured-grid dims from a DIA offset pattern, or None.

    ``(…, Ny, Nx)`` with the +-1 offset the LAST (fastest) axis, matching
    the lexicographic ordering of problems.laplacian_dirichlet_{2d,3d,rect}.
    """
    offs = sorted(offsets)
    if 0 not in offs:
        return None
    pos = [o for o in offs if o > 0]
    if offs != sorted([-o for o in pos] + [0] + pos):
        return None  # not symmetric
    # dims < 3 are rejected: a (k, 2)-shaped "grid" is indistinguishable
    # from a plain banded matrix and the coarsening degenerates
    if len(pos) == 2 and pos[0] == 1:
        nx = pos[1]
        if nx >= 3 and n % nx == 0 and n // nx >= 3:
            return (n // nx, nx)
    if len(pos) == 3 and pos[0] == 1:
        nx, s2 = pos[1], pos[2]
        if nx >= 3 and s2 % nx == 0 and n % s2 == 0:
            ny, nz = s2 // nx, n // s2
            if ny >= 3 and nz >= 3:
                return (nz, ny, nx)
    return None


def _coarse_levels(dims: Tuple[int, ...], min_coarse: int) -> Tuple[Tuple[int, ...], ...]:
    levels = [tuple(dims)]
    while min(levels[-1]) > min_coarse:
        levels.append(tuple(d // 2 for d in levels[-1]))
    return tuple(levels)


# --- separable grid transfer / stencil primitives on (m, *dims) blocks ---


def _shift(x: jax.Array, ax: int, d: int) -> jax.Array:
    """Zero-filled neighbor shift: y[..., i, ...] = x[..., i+d, ...]."""
    size = x.shape[ax]
    pad = [(0, 0)] * x.ndim
    idx = [slice(None)] * x.ndim
    if d > 0:
        pad[ax] = (0, 1)
        idx[ax] = slice(1, size + 1)
    else:
        pad[ax] = (1, 0)
        idx[ax] = slice(0, size)
    return jnp.pad(x, pad)[tuple(idx)]


def _stencil_apply(x: jax.Array, c0, a_axes) -> jax.Array:
    """(c0 I + sum_ax a_ax * (shift+ + shift-)) x; a_axes ordered fastest
    axis first (the +-1 coupling), i.e. a_axes[k] acts on axis -1-k."""
    y = c0 * x
    for k, a in enumerate(a_axes):
        ax = x.ndim - 1 - k
        y = y + a * (_shift(x, ax, 1) + _shift(x, ax, -1))
    return y


def _restrict1(x: jax.Array, ax: int) -> jax.Array:
    """Full weighting along ``ax``: coarse j sits at fine 2j+1 (0-based),
    r_H[j] = (f[2j] + 2 f[2j+1] + f[2j+2]) / 4 with zero past the end."""
    d = x.shape[ax]
    m = d // 2
    pad = [(0, 0)] * x.ndim
    pad[ax] = (0, 1)
    xp = jnp.pad(x, pad)

    def strided(start):
        idx = [slice(None)] * x.ndim
        idx[ax] = slice(start, start + 2 * m - 1, 2)
        return xp[tuple(idx)]

    return 0.25 * strided(0) + 0.5 * strided(1) + 0.25 * strided(2)


def _prolong1(c: jax.Array, ax: int, d: int) -> jax.Array:
    """Linear interpolation along ``ax`` back to fine size ``d`` (= 2M or
    2M+1): fine[2j+1] = c[j], fine[2j] = (c[j-1] + c[j]) / 2 (Dirichlet
    zero outside)."""
    m = c.shape[ax]
    pad = [(0, 0)] * c.ndim
    pad[ax] = (1, 0)
    idx = [slice(None)] * c.ndim
    idx[ax] = slice(0, m)
    cl = jnp.pad(c, pad)[tuple(idx)]  # c[j-1], c[-1] = 0
    evens = 0.5 * (cl + c)
    y = jnp.stack([evens, c], axis=ax + 1)  # (..., M, 2, ...)
    shape = list(c.shape)
    shape[ax] = 2 * m
    y = y.reshape(shape)
    if d == 2 * m + 1:
        tail = [slice(None)] * c.ndim
        tail[ax] = slice(m - 1, m)
        y = jnp.concatenate([y, 0.5 * c[tuple(tail)]], axis=ax)
    return y


def _restrict(x: jax.Array) -> jax.Array:
    for ax in range(1, x.ndim):
        x = _restrict1(x, ax)
    return x


def _prolong(c: jax.Array, dims: Tuple[int, ...]) -> jax.Array:
    for k in range(len(dims)):
        c = _prolong1(c, k + 1, dims[k])
    return c


def _coarse_cg(apply_a, b: jax.Array, iters: int) -> jax.Array:
    """Fixed-iteration CG (no data-dependent control flow): the coarsest-grid
    solve. Per-row step lengths like cg_solve_t, dots over the grid axes."""
    axes = tuple(range(1, b.ndim))
    bshape = (-1,) + (1,) * (b.ndim - 1)

    def dot(u, v):
        return jnp.sum(u * v, axis=axes)

    def body(_, st):
        x, r, p, rz = st
        ap = apply_a(p)
        pap = dot(p, ap)
        alpha = jnp.where(pap > 0, rz / jnp.where(pap > 0, pap, 1.0), 0.0)
        x = x + alpha.reshape(bshape) * p
        r = r - alpha.reshape(bshape) * ap
        rz_n = dot(r, r)
        beta = jnp.where(rz > 0, rz_n / jnp.where(rz > 0, rz, 1.0), 0.0)
        p = r + beta.reshape(bshape) * p
        return x, r, p, rz_n

    x0 = jnp.zeros_like(b)
    x, *_ = lax.fori_loop(0, iters, body, (x0, b, b, dot(b, b)))
    return x


# --- memoized solve fns (CLAUDE.md: solver jit caches key on fn identity) ---

_MG_FNS = {}
_MG_CG_FNS = {}


def _geom_of(A_int):
    """(dims, G, n, width) of an internal operand, or ValueError."""
    n = A_int.shape[0]
    offsets = getattr(A_int, "offsets", None)
    if offsets is None:
        raise ValueError(
            f"multigrid: {type(A_int).__name__} is not a DIA operand"
        )
    dims = detect_grid_dims(offsets, n)
    if dims is None:
        raise ValueError(
            f"multigrid: offsets {A_int.offsets} are not a structured "
            "2D/3D stencil pattern"
        )
    if isinstance(A_int, PaddedDIA):
        return dims, A_int.guard, n, A_int.data.shape[1]
    return dims, 0, n, n


def _sampled_coeffs(A_int, dims, G):
    """In-trace interior stencil coefficients: (c0, a_axes, sigma), f32.

    a_axes is ordered fastest axis first (offset +1, +Nx, +Nx*Ny); sigma is
    the zeroth-order remainder (the eigenvalue shift for A + shift*I-type
    operands), held fixed across levels while the couplings scale by 1/4.
    """
    strides = []
    s = 1
    for d in reversed(dims):
        strides.append(s)
        s *= d
    mid = sum((d // 2) * st for d, st in zip(reversed(dims), strides))
    data = A_int.data
    c0 = data[A_int.offsets.index(0), G + mid].astype(jnp.float32)
    a_axes = tuple(
        data[A_int.offsets.index(st), G + mid].astype(jnp.float32)
        for st in strides
    )
    sigma = c0 + 2.0 * sum(a_axes)
    return c0, a_axes, sigma


def _vcycle_coarse(levels, level, b, a_fine, sigma, nu1, nu2, omega,
                   coarse_iters):
    """Replicable coarse-level V-cycle recursion on (m, *dims) blocks:
    matrix-free rediscretized stencils, damped-Jacobi smoothing, fixed-
    iteration f32 CG at the coarsest level. Module-level so the distributed
    layer (dist/mg.py) can run the identical coarse correction replicated
    on every shard after its semi-coarse all_gather."""
    dims_l = levels[level]
    a_l = tuple(a * (0.25**level) for a in a_fine)
    c0_l = sigma - 2.0 * sum(a_l)
    if level == len(levels) - 1:
        a32 = tuple(a.astype(jnp.float32) for a in a_l)
        x = _coarse_cg(
            lambda v: _stencil_apply(v, c0_l.astype(jnp.float32), a32),
            b.astype(jnp.float32),
            coarse_iters,
        )
        return x.astype(b.dtype)
    dt = b.dtype
    inv_c = (omega / c0_l).astype(dt)
    a_dt = tuple(a.astype(dt) for a in a_l)
    c0_dt = c0_l.astype(dt)
    apply_l = lambda v: _stencil_apply(v, c0_dt, a_dt)  # noqa: E731
    x = inv_c * b
    for _ in range(nu1 - 1):
        x = x + inv_c * (b - apply_l(x))
    r = b - apply_l(x)
    e = _vcycle_coarse(levels, level + 1, _restrict(r), a_fine, sigma,
                       nu1, nu2, omega, coarse_iters)
    x = x + _prolong(e, dims_l)
    for _ in range(nu2):
        x = x + inv_c * (b - apply_l(x))
    return x


def _mg_solve_fn(geom, levels, cycles, nu1, nu2, omega, coarse_iters, dtype):
    key = (
        geom,
        levels,
        int(cycles),
        int(nu1),
        int(nu2),
        float(omega),
        int(coarse_iters),
        None if dtype is None else jnp.dtype(dtype).name,
    )
    if key in _MG_FNS:
        return _MG_FNS[key]
    dims, G, n, width = geom

    def vcycle_coarse(level, b, a_fine, sigma):
        return _vcycle_coarse(levels, level, b, a_fine, sigma, nu1, nu2,
                              omega, coarse_iters)

    def solve(aux, Xt):
        A_, inv_d = aux
        out_dt = Xt.dtype
        _, a_fine, sigma = _sampled_coeffs(A_, dims, G)
        if dtype is not None:
            A_, inv_d, Xt = (
                _cast_floating(A_, dtype),
                inv_d.astype(dtype),
                Xt.astype(dtype),
            )
        m = Xt.shape[0]
        wdiag = (jnp.asarray(omega, Xt.dtype) * inv_d)[None, :]
        b = Xt
        x = wdiag * b  # first Jacobi sweep from x = 0
        for cyc in range(cycles):
            for _ in range(nu1 - 1 if cyc == 0 else nu1):
                x = x + wdiag * (b - spmm_t(A_, x))
            if len(levels) > 1:
                r = b - spmm_t(A_, x)
                r_log = lax.slice(r, (0, G), (m, G + n))
                e = vcycle_coarse(
                    1,
                    _restrict(r_log.reshape((m,) + dims)),
                    a_fine,
                    sigma,
                )
                e = _prolong(e, dims)
                x = x + jnp.pad(
                    e.reshape(m, n), ((0, 0), (G, width - G - n))
                )
            for _ in range(nu2):
                x = x + wdiag * (b - spmm_t(A_, x))
        return x.astype(out_dt)

    solve.layout_t = True
    _MG_FNS[key] = solve
    return solve


def _inv_diag_of(A_int):
    if isinstance(A_int, PaddedDIA):
        return 1.0 / A_int.padded_diagonal(fill=1.0)
    return 1.0 / A_int.diagonal()


def mg_inverse_factory(
    cycles: int = 1,
    nu1: int = 2,
    nu2: int = 2,
    omega: float = 0.8,
    coarse_iters: int = 48,
    min_coarse: int = 6,
    dtype=None,
):
    """``cycles`` V(nu1,nu2)-cycles as an approximate inverse: the LOBPCG /
    Chebyshev-free preconditioner for structured 2D/3D stencil operands.
    Raises ValueError from ``inverse(A)`` when the offsets are not a
    structured stencil pattern (callers fall back to the Krylov engines)."""

    def inverse(A_int):
        geom = _geom_of(A_int)
        levels = _coarse_levels(geom[0], min_coarse)
        fn = _mg_solve_fn(
            geom, levels, cycles, nu1, nu2, omega, coarse_iters, dtype
        )
        return ((A_int, _inv_diag_of(A_int)), fn)

    inverse.internal = True
    return inverse


def _mg_cg_solve_fn(geom, levels, rtol, maxiter, cycles, nu1, nu2, omega,
                    coarse_iters, dtype):
    key = (
        geom, levels, float(rtol), int(maxiter), int(cycles), int(nu1),
        int(nu2), float(omega), int(coarse_iters),
        None if dtype is None else jnp.dtype(dtype).name,
    )
    if key in _MG_CG_FNS:
        return _MG_CG_FNS[key]
    mg_fn = _mg_solve_fn(geom, levels, cycles, nu1, nu2, omega, coarse_iters,
                         dtype=None)

    def solve(aux, Xt):
        A_, _ = aux
        out_dt = Xt.dtype
        if dtype is not None:
            aux = _cast_floating(aux, dtype)
            A_, _ = aux
            Xt = Xt.astype(dtype)
        Y, _ = cg_solve_t(
            lambda V: spmm_t(A_, V),
            Xt,
            rtol=rtol,
            maxiter=maxiter,
            precond_apply=lambda R: mg_fn(aux, R),
        )
        return Y.astype(out_dt)

    solve.layout_t = True
    _MG_CG_FNS[key] = solve
    return solve


def mg_cg_inverse_factory(
    rtol: float = 1e-5,
    maxiter: int = 100,
    cycles: int = 1,
    nu1: int = 2,
    nu2: int = 2,
    omega: float = 0.8,
    coarse_iters: int = 48,
    min_coarse: int = 6,
    dtype=None,
):
    """V-cycle-preconditioned CG to ``rtol``: the converging inner solve for
    shift-invert subspace iteration on wide-band (3D) stencils — O(1)
    condition number after preconditioning, vs O(sqrt(kappa)) for the
    Chebyshev-Jacobi route (factorize/chebyshev.py)."""

    def inverse(A_int):
        geom = _geom_of(A_int)
        levels = _coarse_levels(geom[0], min_coarse)
        fn = _mg_cg_solve_fn(
            geom, levels, rtol, maxiter, cycles, nu1, nu2, omega,
            coarse_iters, dtype,
        )
        return ((A_int, _inv_diag_of(A_int)), fn)

    inverse.internal = True
    return inverse
