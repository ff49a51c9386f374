"""Distributed geometric-multigrid V-cycle preconditioner for the sharded
LOBPCG driver (dist/sharded.py) — the north-star recipe on a mesh.

The single-device MG engine (factorize/multigrid.py) is the preconditioner
of the structured-stencil north-star recipe (one V(1,1) bf16 cycle). This
module runs the
same mathematical cycle under ``shard_map`` over a row-partitioned (z-slab)
operator with ONE collective per cycle:

* **fine level — partitioned**: damped-Jacobi smoothing and the residual go
  through the engine's halo-exchange SpMM (``_ShardEngine.apply``),
  exactly the solver hot path; nothing new crosses shard boundaries.
* **semi-coarsening — local**: full-weighting restriction over the NON-
  partitioned grid axes (x, y in 3D) is shard-local, shrinking the residual
  4x (3D) before any communication.
* **one ``all_gather``** along the slab axis replicates the semi-coarse
  residual (m, Nz, Ny/2, Nx/2) on every shard — for the 10M-dof block that
  is the only inter-device traffic of the whole cycle.
* **coarse levels — replicated**: the slab-axis restriction and the entire
  coarse V-cycle recursion (``factorize.multigrid._vcycle_coarse``: matrix-
  free rediscretized stencils, coarsest-level f32 CG) run identically on
  every shard — redundant compute on a geometrically-shrinking tail instead
  of per-level halo exchanges. The prolonged slab-axis correction is then
  sliced back to the local slab (no communication) and interpolated up the
  local axes.

In exact arithmetic the cycle is identical to the single-chip V-cycle, so
the sharded and single-chip preconditioned solvers agree to roundoff
(tests/test_dist_mg.py). The reference has no distributed layer at all
(SURVEY.md §2.2: MPI deliberately disabled, src/dune-eigensolver.cc:742-748).

Constraints (checked, ``ValueError``): the global operator must be a
structured 2D/3D stencil (``detect_grid_dims``), the slab axis extent must
divide by the mesh size with at least 4 planes per shard (so every shard can
sample interior stencil coefficients), and the row padding of non-divisible
``n`` must be empty (padding rows would break the grid structure).
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
from jax import lax

from dune_eigensolver_tpu.factorize.multigrid import (
    _coarse_levels,
    _prolong1,
    _restrict1,
    _sampled_coeffs,
    _vcycle_coarse,
    detect_grid_dims,
)


def sharded_mg_geometry(
    offsets, n_global: int, n_pad: int, P: int, min_coarse: int = 6
):
    """Validate and return the grid dims for the distributed V-cycle, or
    raise ValueError. ALL misuse raises here — callers run this OUTSIDE
    shard_map so errors raise instead of tracing (make_sharded_mg_prec_fn
    itself is called inside the trace and only asserts).

    Error contract / caller obligations:

    * the operator must be a structured 2D/3D stencil on ITS OWN pattern
      (``detect_grid_dims``) with no mesh row-padding;
    * the slab axis must divide by P with >= 4 planes per shard;
    * the grid must coarsen at least once above ``min_coarse``;
    * **constant stencil coefficients** (Laplacian-like): the gate is
      purely structural, and the replicated coarse levels are built from
      the coefficients each shard samples at its OWN interior row —
      variable-coefficient operators pass detection but the shards'
      "replicated" coarse cycles then silently diverge, degrading the
      preconditioner (LOBPCG stays correct — a preconditioner only has to
      be SPD — but convergence suffers and the change-based stopping rule
      can mask the stall). Use precond='cg' for variable coefficients.
    """
    import math

    if n_pad != n_global:
        raise ValueError(
            f"sharded mg: n={n_global} is padded to {n_pad} for the mesh — "
            "identity pad rows break the grid structure (pick a mesh size "
            "that divides n, or use precond='cg')"
        )
    dims = detect_grid_dims(tuple(offsets), n_global)
    if dims is None:
        raise ValueError(
            f"sharded mg: offsets {tuple(offsets)} are not a structured "
            "2D/3D stencil pattern"
        )
    if dims[0] % P != 0 or dims[0] // P < 4:
        raise ValueError(
            f"sharded mg: slab axis {dims[0]} over {P} shards gives "
            f"{dims[0] / P:g} planes/shard; need a multiple of P with >= 4 "
            "planes so every shard samples interior stencil coefficients"
        )
    if len(_coarse_levels(tuple(dims), min_coarse)) < 2:
        raise ValueError(
            f"sharded mg: grid {dims} has no coarse level above "
            f"min_coarse={min_coarse}"
        )
    nloc = n_pad // P
    if (dims[0] // P) * math.prod(dims[1:]) != nloc:
        raise ValueError(
            f"sharded mg: local rows {nloc} != slab "
            f"{(dims[0] // P,) + tuple(dims[1:])}"
        )
    return dims


def make_sharded_mg_prec_fn(
    eng,
    dims,
    P: int,
    axis: str,
    nu1: int = 1,
    nu2: int = 1,
    omega: float = 0.8,
    coarse_iters: int = 48,
    min_coarse: int = 6,
    dtype=None,
):
    """Build ``prec_fn(_aux, X) -> Y`` for the sharded LOBPCG core: one
    V(nu1, nu2) cycle on the shifted operand (engine operand 0). Called
    INSIDE shard_map on the engine's internal multivector layout."""
    import math

    lnz = dims[0] // P
    dims_loc = (lnz,) + tuple(dims[1:])
    nloc = eng.nloc
    # geometry was validated by sharded_mg_geometry OUTSIDE the trace
    # (misuse raises there, not mid-trace); these only guard internal
    # consistency between the engine and the validated dims.
    assert lnz * math.prod(dims[1:]) == nloc, (dims_loc, nloc)
    levels = _coarse_levels(tuple(dims), min_coarse)
    assert len(levels) >= 2, (dims, min_coarse)
    if eng.mode == "padded":
        G = eng.layout.G
        width = eng.layout.width
    else:
        G, width = 0, nloc
    m_grid = 1 + len(dims)  # block ndim on the grid: (m, z, y[, x])
    local_axes = tuple(range(2, m_grid))  # non-partitioned grid axes
    # every shard samples ITS OWN slab's interior row; constant-coefficient
    # stencils make the values (and hence the replicated coarse levels)
    # identical across shards
    a_loc = SimpleNamespace(data=eng.datas[0], offsets=eng.offsets_list[0])
    apply_a = eng.apply(0, dtype=dtype)
    inv_d = eng.inv_diag(0)

    def prec_fn(_aux, X):
        out_dt = X.dtype
        _, a_fine, sigma = _sampled_coeffs(a_loc, dims_loc, 0)
        b = X if dtype is None else X.astype(dtype)
        inv_diag = inv_d if dtype is None else inv_d.astype(dtype)
        wdiag = (jnp.asarray(omega, b.dtype) * inv_diag)[None, :]
        m = b.shape[0]
        # --- fine level: partitioned pre-smoothing (halo SpMM) ---
        x = wdiag * b
        for _ in range(nu1 - 1):
            x = x + wdiag * (b - apply_a(x))
        r = b - apply_a(x)
        r_log = lax.slice(r, (0, G), (m, G + nloc))
        r_grid = r_log.reshape((m,) + dims_loc)
        # --- local semi-coarsening over the non-partitioned axes ---
        for ax in local_axes:
            r_grid = _restrict1(r_grid, ax)
        # --- the one collective: replicate the semi-coarse residual ---
        r_full = lax.all_gather(r_grid, axis, axis=1, tiled=True)
        # --- replicated: slab-axis restriction -> level-1 grid, then the
        # single-chip coarse V-cycle recursion ---
        r1 = _restrict1(r_full, 1)
        e1 = _vcycle_coarse(
            levels, 1, r1, a_fine, sigma, nu1, nu2, omega, coarse_iters
        )
        # --- replicated slab-axis prolongation, slice the local slab ---
        ez = _prolong1(e1, 1, dims[0])
        idx = lax.axis_index(axis)
        e_loc = lax.dynamic_slice_in_dim(ez, idx * lnz, lnz, axis=1)
        # --- local prolongation up the non-partitioned axes ---
        for k, ax in enumerate(local_axes):
            e_loc = _prolong1(e_loc, ax, dims[1 + k])
        x = x + jnp.pad(
            e_loc.reshape(m, nloc), ((0, 0), (G, width - G - nloc))
        )
        # --- fine level: partitioned post-smoothing ---
        for _ in range(nu2):
            x = x + wdiag * (b - apply_a(x))
        return x.astype(out_dt)

    return prec_fn
