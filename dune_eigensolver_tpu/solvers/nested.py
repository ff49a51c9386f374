"""Nested-iteration LOBPCG: seed the fine-grid solve from coarser grids.

Full-multigrid-style eigensolving, a capability beyond the
reference's solver set (the reference always starts from seeded random
vectors, eigensolver.hh:50-55): the smallest eigenvectors of an elliptic
operator are smooth, so the same solve on a half-resolution grid — 8x
cheaper per iteration in 3D — yields a start block that the multigrid
prolongation (factorize/multigrid.py::_prolong, linear interpolation)
carries to the fine grid with O(h^2) accuracy. The fine-grid LOBPCG then
only pays the few iterations that correct the interpolation error instead
of building the subspace from noise.

On the north-star problem (smallest-20 of the 10.1M-dof 3D Dirichlet
Laplacian) the three-level nest (54^3 -> 108^3 -> 216^3, coarse_tol=2e-4)
needs only a few fine iterations instead of the single-level recipe's
dozen, and lands closer to the analytic spectrum, because the seeded
iterations start inside the target subspace. Times on the GPU are in
PERF.md.

The coarse hierarchy is derived from the operand itself: grid dims are
detected from the DIA offset pattern and the interior stencil coefficients
are sampled in-trace (the same machinery the geometric-MG preconditioner
uses, factorize/multigrid.py), then each coarse operator is assembled ON
DEVICE with the same coefficients and Dirichlet masking — nothing ships
from the host. Same-coefficient rediscretization is exact for the
constant-coefficient operators this targets; for anything else the coarse
eigenVECTORS (all that seeding uses) remain first-order accurate.

Scope: standard-problem embeddings (``b_identity=True``), the operand
class of the north-star protocol. For generalized pencils whose B does not
rediscretize trivially, call ``lobpcg_generalized`` with an explicit
``q0`` built via :func:`prolong_vectors` from whatever coarse solve the
application can construct.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from dune_eigensolver_tpu.factorize.multigrid import (
    _prolong,
    _sampled_coeffs,
    detect_grid_dims,
)
from dune_eigensolver_tpu.solvers.engine import memoized_setup
from dune_eigensolver_tpu.solvers.lobpcg import lobpcg_generalized
from dune_eigensolver_tpu.solvers.result import EigenResult
from dune_eigensolver_tpu.solvers.standard import padded_width
from dune_eigensolver_tpu.sparse.formats import DIAMatrix


@partial(jax.jit, static_argnums=(1, 2))
def _prolong_block(Y: jax.Array, coarse_dims: Tuple[int, ...],
                   fine_dims: Tuple[int, ...]) -> jax.Array:
    m = Y.shape[1]
    C = Y.T.reshape((m,) + tuple(coarse_dims))
    F = _prolong(C, tuple(fine_dims))
    return F.reshape(m, -1).T


def prolong_vectors(Y: jax.Array, coarse_dims: Tuple[int, ...],
                    fine_dims: Tuple[int, ...]) -> jax.Array:
    """Interpolate an ``(n_coarse, m)`` eigenvector block from a structured
    grid of ``coarse_dims`` to ``fine_dims`` (each fine extent = 2*coarse
    or 2*coarse+1; separable linear interpolation, Dirichlet-zero outside
    — the MG prolongation). Public building block for seeding
    ``lobpcg_generalized(q0=...)`` from an application-provided coarse
    solve."""
    return _prolong_block(Y, tuple(coarse_dims), tuple(fine_dims))


@partial(jax.jit, static_argnums=(0, 3))
def _stencil_dia_data(dims: Tuple[int, ...], c0: jax.Array, a_axes,
                      dtype) -> jax.Array:
    """Device-assembled DIA data for a separable +-1-per-axis stencil on
    ``dims`` with interior coefficients (c0, a_axes) and Dirichlet masking
    (couplings across the lexicographic wrap are zeroed) — the
    problems._laplacian_3d_device pattern for arbitrary coefficients."""
    n = 1
    for d in dims:
        n *= d
    i = jnp.arange(n, dtype=jnp.int32)
    strides = []
    s = 1
    for d in reversed(dims):
        strides.append(s)
        s *= d
    lo, hi = [], []
    for k, (st, a) in enumerate(zip(strides, a_axes)):
        d = dims[len(dims) - 1 - k]
        ax = (i // st) % d
        a_ = a.astype(dtype)
        lo.append(jnp.where(ax != 0, a_, jnp.asarray(0.0, dtype)))
        hi.append(jnp.where(ax != d - 1, a_, jnp.asarray(0.0, dtype)))
    center = jnp.full((n,), 1.0, dtype) * c0.astype(dtype)
    # offsets ascending: (-s_max ... -1, 0, +1 ... +s_max)
    rows = list(reversed(lo)) + [center] + hi
    return jnp.stack(rows)


def _coarse_operator(A: DIAMatrix, dims: Tuple[int, ...]) -> DIAMatrix:
    """Same-coefficient rediscretization of the DIA operand ``A`` on the
    coarser structured grid ``dims`` (coefficients sampled in-trace at an
    interior point, exactly like the MG preconditioner's coarse levels)."""
    c0, a_axes, _sigma = _sampled_coeffs(A, detect_grid_dims(A.offsets, A.shape[0]), 0)
    data = _stencil_dia_data(tuple(dims), c0, a_axes, jnp.dtype(A.dtype))
    strides = []
    s = 1
    for d in reversed(dims):
        strides.append(s)
        s *= d
    offsets = tuple(-st for st in reversed(strides)) + (0,) + tuple(strides)
    n = 1
    for d in dims:
        n *= int(d)
    return DIAMatrix(data=data, offsets=offsets, shape=(n, n))


def _identity_b(n: int, dtype) -> DIAMatrix:
    return DIAMatrix(
        data=jnp.ones((1, n), dtype), offsets=(0,), shape=(n, n)
    )


def lobpcg_nested(
    A: DIAMatrix,
    B,
    nev: int,
    tol: float,
    maxiter: int,
    *,
    min_coarse: int = 48,
    coarse_tol: Optional[float] = None,
    coarse_min_iter: int = 3,
    min_iter: int = 1,
    block: int = 8,
    **lobpcg_kwargs,
) -> EigenResult:
    """Smallest-nev eigenpairs of ``A x = lambda x`` by nested-iteration
    LOBPCG on a structured-grid DIA operand (module docstring).

    Builds the coarse hierarchy by halving the detected grid dims while
    ``min(dims) // 2 >= min_coarse``, solves coarsest-to-finest, and seeds
    each level with the prolonged eigenvector block of the one below.
    Coarse levels solve the full padded block width at ``coarse_tol``
    (default ``max(tol/10, 1e-5)``: over-converging the coarse levels is
    nearly free and cuts fine-grid iterations).

    Requires ``b_identity=True`` (B is only used as the identity
    embedding); generalized pencils should seed ``lobpcg_generalized``
    directly via :func:`prolong_vectors`. All other keyword arguments
    (``precond``, ``ortho_block``, ``shift`` ...) are forwarded to every
    level's ``lobpcg_generalized`` call.
    """
    if not lobpcg_kwargs.get("b_identity", False):
        raise ValueError(
            "lobpcg_nested requires b_identity=True (standard-problem "
            "embedding); for a general B build the seed with "
            "prolong_vectors and call lobpcg_generalized(q0=...)"
        )
    if "q0" in lobpcg_kwargs:
        raise ValueError(
            "lobpcg_nested derives q0 from the coarse hierarchy; to use "
            "your own seed call lobpcg_generalized(q0=...) directly"
        )
    n = A.shape[0]
    dims = detect_grid_dims(A.offsets, n)
    if dims is None:
        raise ValueError(
            f"lobpcg_nested: offsets {A.offsets} are not a structured "
            "2D/3D stencil pattern; pass q0 to lobpcg_generalized instead"
        )
    levels = [tuple(dims)]
    while min(levels[0]) // 2 >= min_coarse:
        levels.insert(0, tuple(d // 2 for d in levels[0]))
    ctol = coarse_tol if coarse_tol is not None else max(tol / 10.0, 1e-5)
    m = padded_width(nev, block)

    def build_hierarchy():
        ops = []
        for dims_c in levels[:-1]:
            Ac = _coarse_operator(A, dims_c)
            ops.append((Ac, _identity_b(Ac.shape[0], Ac.dtype)))
        return tuple(ops)

    # the coarse operators are memoized on the fine operand's identity so
    # repeated solves hit the per-level engine/preconditioner setup caches
    coarse = memoized_setup(
        (A,), ("nested_hier",) + tuple(levels[0]) + (len(levels),),
        build_hierarchy,
    )

    q0 = None
    for lvl, dims_l in enumerate(levels):
        last = lvl == len(levels) - 1
        Al, Bl = (A, B) if last else coarse[lvl]
        res = lobpcg_generalized(
            Al,
            Bl,
            nev=nev if last else m,
            tol=tol if last else ctol,
            maxiter=maxiter,
            block=block,
            min_iter=min_iter if (last and q0 is not None) else coarse_min_iter,
            q0=q0,
            **lobpcg_kwargs,
        )
        if not last:
            q0 = prolong_vectors(res.eigenvectors, dims_l, levels[lvl + 1])
    return res
