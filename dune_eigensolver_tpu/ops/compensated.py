"""Error-free-transform (compensated) f32 arithmetic for the tight-accuracy
refinement path.

The reference runs end-to-end f64 (eigensolver.hh works on doubles and the
1e-14 ARPACK oracle protocol at src/dune-eigensolver.cc:559-614 assumes it).
Instead of iterating in f64, the framework can iterate in f32 and run ONE
compensated
Rayleigh-Ritz pass at the end (solvers/refine.py): subspace error eps enters
Ritz values only at O(eps^2), so the accuracy bottleneck is the GRAM
computation — restored here to "as if f64" via classical error-free
transforms in pure f32:

* ``twosum``  — Knuth's branch-free exact addition: a + b = s + e exactly.
* ``twoprod`` — Dekker/Veltkamp split product: a * b = p + e exactly
  (no FMA dependence: the 2^s+1 splitting keeps every sub-product exact).
* ``sum2``    — pairwise-tree compensated reduction (Ogita-Rump-Oishi dot2
  reshaped for vector hardware: every tree level is one elementwise pass
  over a
  halved array, log2(n) levels, no sequential scan).
* ``dot2_rows`` / ``spmm2_dia_t`` — compensated row dots and DIA SpMM
  returning (hi, lo) pairs with hi + lo accurate to O(u^2 * n).

Everything is jittable, shape-static, and f32-native — it needs no x64
flag.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax


def _split_factor(dtype) -> float:
    # Veltkamp split constant 2^ceil(p/2) + 1 (p = mantissa bits + 1)
    if jnp.dtype(dtype) == jnp.float32:
        return 4097.0  # 2^12 + 1
    if jnp.dtype(dtype) == jnp.float64:
        return 134217729.0  # 2^27 + 1
    raise TypeError(f"compensated: unsupported dtype {dtype}")


def twosum(a: jax.Array, b: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(s, e) with s = fl(a + b) and a + b = s + e exactly (Knuth)."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _split(a: jax.Array) -> Tuple[jax.Array, jax.Array]:
    c = _split_factor(a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def twoprod(a: jax.Array, b: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(p, e) with p = fl(a * b) and a * b = p + e exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def sum2(x: jax.Array, axis: int = -1) -> Tuple[jax.Array, jax.Array]:
    """Compensated reduction: (hi, lo) with hi + lo = sum(x) to O(u^2 n).

    Pairwise tree of twosums; the error terms accumulate in plain f32
    (their own rounding is second order). The reduced axis is brought last
    and padded to a power of two with exact zeros.
    """
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    width = 1 if n <= 1 else 1 << (n - 1).bit_length()
    if width != n:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, width - n)])
    err = jnp.zeros_like(x)
    while width > 1:
        width //= 2
        a = x[..., :width]
        b = x[..., width:]
        x, e_new = twosum(a, b)
        err = err[..., :width] + err[..., width:] + e_new
    return x[..., 0], err[..., 0]


def dot2_rows(X: jax.Array, Y: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Compensated per-row dot of two (m, n) arrays: (hi, lo) of shape (m,)
    with hi + lo = sum_n X*Y row-wise to O(u^2 n) (dot2 of Ogita et al.)."""
    p, ep = twoprod(X, Y)
    hi, lo = sum2(p, axis=-1)
    return hi, lo + jnp.sum(ep, axis=-1)


def gram2_t(X: jax.Array, Y: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Compensated Gram G = X @ Y.T for transposed (m, n) multivectors:
    (hi, lo) of shape (mx, my). The my loop is static (m is small), each
    step one vectorized dot2 pass — no (m, m, n) intermediate."""
    my = Y.shape[0]
    cols_hi, cols_lo = [], []
    for j in range(my):
        hi, lo = dot2_rows(X, jnp.broadcast_to(Y[j][None, :], X.shape))
        cols_hi.append(hi)
        cols_lo.append(lo)
    return jnp.stack(cols_hi, axis=1), jnp.stack(cols_lo, axis=1)


def spmm2_dia_t(A, Xt: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Compensated DIA SpMM in the transposed layout: (hi, lo) with
    hi + lo = (A @ X)^T to O(u^2 ndiag). One-shot refinement use — plain
    XLA formulation (shifted slices), every product and accumulation an
    error-free transform."""
    m, n = Xt.shape
    halo = max((abs(o) for o in A.offsets), default=0)
    Xp = jnp.pad(Xt, ((0, 0), (halo, halo)))
    hi = jnp.zeros_like(Xt)
    lo = jnp.zeros_like(Xt)
    for d, off in enumerate(A.offsets):
        shifted = lax.slice(Xp, (0, halo + off), (m, halo + off + n))
        p, ep = twoprod(A.data[d][None, :], shifted)
        hi, es = twosum(hi, p)
        lo = lo + ep + es
    return hi, lo


__all__ = [
    "twosum",
    "twoprod",
    "sum2",
    "dot2_rows",
    "gram2_t",
    "spmm2_dia_t",
]
