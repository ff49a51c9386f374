"""Tight-accuracy Rayleigh-Ritz refinement: f64-grade eigenvalues from an
f32 iteration.

The reference's accuracy protocol compares against a tol=1e-14 ARPACK run
in full f64 (src/dune-eigensolver.cc:559-614). An f32 iteration's
converged subspace V carries angle error eps ~ 1e-6..1e-7, and
Rayleigh-Ritz values on a subspace are accurate to O(eps^2) — BELOW 1e-12 —
*provided the projected Gram matrices are computed accurately*. This module
computes G_A = V^T A V and G_B = V^T B V to ~f64 accuracy and solves the
tiny (nev x nev) dense generalized eigenproblem in genuine f64 on the host:

* DIA operands: compensated device pass (ops/compensated.py) — error-free
  twoprod/twosum SpMM + Gram in pure f32 on the device; only the
  (nev, nev) hi/lo pieces travel to the host (the 10M-dof multivector
  never does).
* other operands / small problems: plain host f64 (scipy) projection —
  V uploads f32->f64 exactly.

``ev.refine=on`` in the CLI runs this after the solve and reports the
refined protocol row; target: |lambda - oracle(1e-14)| <= 1e-6 with f32
storage end to end.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from dune_eigensolver_tpu.sparse.formats import DIAMatrix


def _gram_pieces_dia(A: DIAMatrix, Vt: jax.Array):
    """Device-side compensated projection pieces for G = V^T A V:
    (hi, lo) with hi + lo ~ exact to O(u^2). Returns (m, m) f32 pairs."""
    from dune_eigensolver_tpu.ops.compensated import gram2_t, spmm2_dia_t

    Wh, Wl = spmm2_dia_t(A, Vt)
    Gh, Gl = gram2_t(Vt, Wh)
    # first-order correction from the SpMM residue, plain f32 is enough
    # (|Wl| ~ u * scale, its own rounding is second order); force true f32
    # accumulation — never bf16 or TF32 passes — via HIGHEST precision
    corr = jnp.einsum(
        "in,jn->ij", Vt, Wl, precision=jax.lax.Precision.HIGHEST
    )
    return Gh, Gl + corr


_PROJECT_FNS = {}


def _project_fn(offsets_a, shape_a, offsets_b, shape_b):
    key = (offsets_a, shape_a, offsets_b, shape_b)
    if key not in _PROJECT_FNS:

        def run(a_data, b_data, Vt):
            A = DIAMatrix(data=a_data, offsets=offsets_a, shape=shape_a)
            GAh, GAl = _gram_pieces_dia(A, Vt)
            if b_data is None:
                from dune_eigensolver_tpu.ops.compensated import gram2_t

                GBh, GBl = gram2_t(Vt, Vt)
            else:
                B = DIAMatrix(data=b_data, offsets=offsets_b, shape=shape_b)
                GBh, GBl = _gram_pieces_dia(B, Vt)
            return GAh, GAl, GBh, GBl

        _PROJECT_FNS[key] = jax.jit(run)
    return _PROJECT_FNS[key]


def refine_eigenpairs(
    A,
    B,
    V,
    nev: Optional[int] = None,
    rotate_vectors: bool = False,
) -> Tuple[np.ndarray, Optional[jax.Array]]:
    """f64-grade Ritz values of the pencil (A, B) on the span of V.

    V: (n, m) converged f32 eigenvector block (column layout, any solver's
    ``result.eigenvectors``). B=None means the standard problem. Returns
    (eigenvalues ascending as np.float64 [nev], rotated V or None).
    """
    n, m = V.shape
    nev = m if nev is None else min(nev, m)
    Vt = jnp.asarray(V).T

    b_is_dia = B is None or isinstance(B, DIAMatrix)
    if isinstance(A, DIAMatrix) and b_is_dia:
        fn = _project_fn(
            A.offsets,
            A.shape,
            None if B is None else B.offsets,
            None if B is None else B.shape,
        )
        GAh, GAl, GBh, GBl = fn(A.data, None if B is None else B.data, Vt)
        GA = np.asarray(GAh, np.float64) + np.asarray(GAl, np.float64)
        GB = np.asarray(GBh, np.float64) + np.asarray(GBl, np.float64)
    else:
        # host f64 projection (exact upcast of V)
        V64 = np.asarray(V, np.float64)
        As = A.to_scipy().astype(np.float64)
        GA = V64.T @ (As @ V64)
        if B is None:
            GB = V64.T @ V64
        else:
            Bs = B.to_scipy().astype(np.float64)
            GB = V64.T @ (Bs @ V64)

    import scipy.linalg as sla

    GA = 0.5 * (GA + GA.T)
    GB = 0.5 * (GB + GB.T)
    # B may be semidefinite (GenEO partition-of-unity mass) and the block
    # may carry near-null-B directions: whiten on the B-positive subspace
    # instead of calling eigh(GA, GB) directly (which requires GB > 0).
    db, Ub = sla.eigh(GB)
    keep = db > db.max() * 1e-12
    W = Ub[:, keep] / np.sqrt(db[keep])[None, :]
    w, Cw = sla.eigh(W.T @ GA @ W)
    C = W @ Cw
    w = w[:nev]
    if not rotate_vectors:
        return w, None
    Vr = jnp.matmul(jnp.asarray(V), jnp.asarray(C[:, :nev], jnp.asarray(V).dtype),
                    precision=jax.lax.Precision.HIGHEST)
    return w, Vr


__all__ = ["refine_eigenpairs"]
