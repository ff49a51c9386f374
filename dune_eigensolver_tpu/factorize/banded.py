"""Block-banded direct factorization: the on-device shift-invert engine.

The reference applies ``A^{-1}`` to 8 RHS at a time through an externalized
UMFPACK LU with row-sequential forward/backward substitution
(umfpacktools.hh:16-220, kernels_cpp.hh:660-755). A row-sequential sweep is
the worst possible shape for a wide vector machine; but every operator in
the reference
driver (2D 5-point / 3D 7-point Laplacians, partition-of-unity B,
src/dune-eigensolver.cc:98-156) is *banded* in natural ordering, and a
no-pivot factorization of a banded matrix fills only inside the band. So:

* **Host setup**: banded Cholesky (``scipy.linalg.cholesky_banded``) when the
  shifted operator is SPD, else a no-pivot banded LU (same band algebra,
  written in numpy over the band array). Fill never leaves the band, so band
  storage is exact — no sparsity indices at all.
* **Externalization**: the factor is cut into ``C x C`` dense blocks: the
  (block-)subdiagonal blocks are kept as-is and every diagonal block is
  **explicitly inverted on the host** (f64, then cast). This is the
  partitioned-inverse method: the device never runs a triangular solve.
* **Device solve**: one ``lax.scan`` over block rows; each step is
  ``x_i = Dinv_i @ (b_i - sum_j Sub_{i,j} @ x_{i-j-1})`` — nothing but dense
  (C, C) @ (C, m) matmuls, zero gathers, zero sequential scalar
  work. The backward sweep reuses the same scan on the reversed blocks.

Memory: 2 * nblocks * (k+1) * C^2 floats where k = ceil(bw / C); for the 2D
Laplacian at N=256 (bw=256=C) that is ~134 MB in f32 — vs ~1.3 GB for a
level-scheduled gather table of the same factor.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


# ---------------------------------------------------------------------------
# Host-side band factorizations (numpy, f64)
# ---------------------------------------------------------------------------


def _band_from_dia(A) -> Tuple[np.ndarray, int, int]:
    """(band, bw, n) with band[b, i] = A[i, i - bw + b], b in [0, 2bw]."""
    offsets = A.offsets
    bw = max(abs(o) for o in offsets)
    n = A.shape[0]
    data = np.asarray(A.data, dtype=np.float64)
    band = np.zeros((2 * bw + 1, n))
    for d, o in enumerate(offsets):
        band[bw + o] = data[d]
    return band, bw, n


def _cholesky_banded(band: np.ndarray, bw: int, n: int) -> np.ndarray:
    """A = L L^T for SPD banded A. Returns lower band ``lb`` with
    lb[b, i] = L[i + b, i], b in [0, bw]. Raises LinAlgError if not SPD."""
    from scipy.linalg import cholesky_banded

    # scipy wants the upper band: ab[u + i - j, j] = A[i, j], i <= j
    ab = np.zeros((bw + 1, n))
    for b in range(bw + 1):  # superdiagonal b: A[i, i+b]
        ab[bw - b, b:] = band[bw + b, : n - b]
    cb = cholesky_banded(ab, lower=False)  # cb[bw + i - j, j] = R[i, j]
    # L = R^T: L[i + b, i] = R[i, i + b] = cb[bw - b, i + b]
    lb = np.zeros((bw + 1, n))
    for b in range(bw + 1):
        lb[b, : n - b] = cb[bw - b, b:]
    return lb


def _lu_banded(band: np.ndarray, bw: int, n: int):
    """No-pivot banded LU: A = L U with unit-diagonal L. Returns
    (lb, ub): lb[b, i] = L[i + b, i] (b in [1, bw], unit diag implied),
    ub[b, i] = U[i, i + b] (b in [0, bw]). Vectorized rank-1 band updates.

    Requires a no-pivot-stable matrix (diagonally dominant / SPD-like, which
    the shifted, regularized operators of the reference protocol are —
    GeneralizedInverse adds shift*B + reg*I before factorizing,
    eigensolver.hh:241-252)."""
    # work[bw + r, i] = A[i + r, i] = band[bw - r, i + r]
    work = np.zeros((2 * bw + 1, n))
    for r in range(-bw, bw + 1):
        if r >= 0:
            work[bw + r, : n - r] = band[bw - r, r:]
        else:
            work[bw + r, -r:] = band[bw - r, : n + r]
    from dune_eigensolver_tpu.utils import native

    zp = native.lu_banded(work, n, bw) if native.available() else None
    if zp is not None:
        if zp >= 0:
            raise ZeroDivisionError(f"banded LU: zero pivot at row {zp}")
    else:  # pure-numpy fallback (O(n*bw) python loop; fine for small n)
        for i in range(n):
            piv = work[bw, i]
            if piv == 0.0:
                raise ZeroDivisionError(f"banded LU: zero pivot at row {i}")
            r = min(bw, n - 1 - i)
            if r == 0:
                continue
            col = work[bw + 1 : bw + 1 + r, i] / piv  # L[i+1..i+r, i]
            work[bw + 1 : bw + 1 + r, i] = col
            # update trailing A[i+a, i+b] -= L[i+a,i] * U[i, i+b]
            # A[i+a, i+b] = work[bw + a - b, i + b]
            for b in range(1, r + 1):
                u = work[bw - b, i + b]  # U[i, i+b]
                if u != 0.0:
                    work[bw + 1 - b : bw + 1 + r - b, i + b] -= col * u
    lb = np.zeros((bw + 1, n))
    ub = np.zeros((bw + 1, n))
    lb[0] = 1.0
    for b in range(1, bw + 1):
        lb[b, : n - b] = work[bw + b, : n - b]
    for b in range(bw + 1):
        ub[b, : n - b] = work[bw - b, b:]
    return lb, ub


# ---------------------------------------------------------------------------
# Block externalization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BandedFactor:
    """One triangular factor in partitioned-inverse block form (lower,
    forward-substitution orientation; the upper factor is stored reversed).

    dinv: (nb, C, C)   — inverses of the diagonal blocks
    sub:  (nb, k, C, C) — subdiagonal blocks, sub[i, j] = T[blk i, blk i-1-j]
    """

    dinv: jax.Array
    sub: jax.Array
    nb: int  # static
    C: int  # static
    k: int  # static


jax.tree_util.register_dataclass(
    BandedFactor, data_fields=["dinv", "sub"], meta_fields=["nb", "C", "k"]
)


@dataclasses.dataclass(frozen=True)
class BandedFactorization:
    """Externalized A = L U (or L L^T) in block-banded partitioned-inverse
    form, device-resident and jittable. ``fwd`` solves L z = b top-down;
    ``bwd`` holds the upper factor flipped (rows/cols reversed) so the same
    forward scan solves U x = z bottom-up."""

    fwd: BandedFactor
    bwd: BandedFactor
    n: int  # static (unpadded)
    npad: int  # static (nb * C)
    stats: tuple  # static: (bw, C, nb, kind)


jax.tree_util.register_dataclass(
    BandedFactorization, data_fields=["fwd", "bwd"], meta_fields=["n", "npad", "stats"]
)


def _blocks_from_lower_band(lb: np.ndarray, bw: int, n: int, C: int, dtype):
    """Cut a lower-banded factor (lb[b, i] = L[i+b, i], b in [0, bw]) into
    partitioned-inverse blocks. Fully vectorized band->block gathers."""
    nb = -(-n // C)
    npad = nb * C
    k = -(-bw // C)
    # pad the band to npad columns so gathers never go out of range; padded
    # diagonal entries are 1 (identity rows -> inverse stays identity).
    lbp = np.zeros((bw + 1, npad))
    lbp[:, :n] = lb
    lbp[0, n:] = 1.0

    a = np.arange(C)[:, None]  # block-local row
    b = np.arange(C)[None, :]  # block-local col
    r0 = (np.arange(nb) * C)[:, None, None]
    cols = r0 + b[None]  # (nb, C, C) global column index

    # diagonal blocks: L[r0+a, r0+b] = lb[a-b, r0+b] for 0 <= a-b <= bw
    d = (a - b)[None]  # (1, C, C)
    valid = (d >= 0) & (d <= bw)
    dense = np.where(valid, lbp[np.clip(d, 0, bw), cols], 0.0)
    from scipy.linalg import solve_triangular

    eye = np.eye(C)
    dinv = np.empty((nb, C, C))
    for i in range(nb):
        dinv[i] = solve_triangular(dense[i], eye, lower=True, unit_diagonal=False)

    # subdiagonal blocks: sub[i, j] = L[blk i, blk i-1-j];
    # L[r0+a, c0+b] with c0 = r0-(j+1)C -> band index (j+1)C + a - b
    sub = np.zeros((nb, k, C, C))
    for j in range(k):
        dj = (j + 1) * C + a - b  # (C, C)
        validj = dj <= bw  # >= 0 always since (j+1)C >= C > b - a is not...
        validj &= dj >= 0
        cj = cols - (j + 1) * C  # (nb, C, C) global col
        okc = cj >= 0
        cjc = np.clip(cj, 0, npad - 1)
        vals = np.where(validj[None] & okc, lbp[np.clip(dj, 0, bw)[None], cjc], 0.0)
        sub[:, j] = vals
    return (
        jnp.asarray(dinv.astype(dtype)),
        jnp.asarray(sub.astype(dtype)),
        nb,
        npad,
        k,
    )


def factorize_banded(A, C: int = 256, dtype=None, verbose: int = 0) -> BandedFactorization:
    """Factorize a banded (DIA) operator on the host, externalize to device.

    Tries banded Cholesky first (SPD fast path); falls back to no-pivot
    banded LU. ``C`` is the device block size."""
    band, bw, n = _band_from_dia(A)
    dtype = dtype or np.asarray(A.data).dtype
    kind = "cholesky"
    try:
        lb = _cholesky_banded(band, bw, n)
        # A = L L^T: forward factor L, backward factor L^T
        ub = lb  # U = L^T in transposed-band form: U[i, i+b] = L[i+b, i]
    except Exception:
        kind = "lu"
        lb, ub = _lu_banded(band, bw, n)

    dinvF, subF, nb, npad, k = _blocks_from_lower_band(lb, bw, n, C, dtype)
    # upper factor U (ub[b, i] = U[i, i+b]) solved bottom-up == forward solve
    # on the reversed matrix over the full padded range (padding rows are
    # identity): Urev[p + b, p] = U[npad-1-p-b, npad-1-p] = ubp[b, npad-1-p-b]
    ubp = np.zeros((bw + 1, npad))
    ubp[:, :n] = ub
    ubp[0, n:] = 1.0
    ub_rev = np.zeros_like(ubp)
    for b in range(bw + 1):
        ub_rev[b, : npad - b] = ubp[b, : npad - b][::-1]
    dinvB, subB, _, _, _ = _blocks_from_lower_band(ub_rev, bw, npad, C, dtype)

    if verbose > 0:
        mb = (dinvF.size + subF.size + dinvB.size + subB.size) * np.dtype(dtype).itemsize / 1e6
        print(
            f"factorize_banded: n={n} bw={bw} kind={kind} C={C} nb={nb} k={k} "
            f"device factors {mb:.0f} MB"
        )
    return BandedFactorization(
        fwd=BandedFactor(dinv=dinvF, sub=subF, nb=nb, C=C, k=k),
        bwd=BandedFactor(dinv=dinvB, sub=subB, nb=nb, C=C, k=k),
        n=n,
        npad=npad,
        stats=(bw, C, nb, kind),
    )


# ---------------------------------------------------------------------------
# Device-side factorization (the on-device setup path)
# ---------------------------------------------------------------------------
#
# The host paths above move O(n * bw) factor data host->device, a transfer
# that can dominate setup. When the bandwidth fits
# one block (bw <= C, always true for 2D stencils with C >= N), the operator
# is block *tridiagonal* in C-blocks and the whole factorization can run on
# device as a lax.scan of dense (C, C) ops — only the DIA diagonals
# (ndiag * n values) ever leave the host. This goes beyond the reference,
# whose factorization is strictly a host-library call (umfpacktools.hh:100).


from functools import partial


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _dia_to_block_tridiag(A, C: int, npad: int, nb: int, dtype):
    """Device-side (nb, C, C) block-diagonal / sub / super extraction from
    DIA storage (one fused jit). Padding rows (n..npad) get an identity
    diagonal."""
    n = A.shape[0]
    a_idx = np.arange(C)
    Aii = jnp.zeros((nb, C, C), dtype)
    Asub = jnp.zeros((nb, C, C), dtype)
    Asup = jnp.zeros((nb, C, C), dtype)
    for d, o in enumerate(A.offsets):
        row = jnp.pad(A.data[d].astype(dtype), (0, npad - n)).reshape(nb, C)
        if abs(o) > C:
            raise ValueError(f"offset {o} exceeds block size {C}")
        # rows a with 0 <= a+o < C stay in the diagonal block
        lo, hi = max(0, -o), min(C, C - o)
        Aii = Aii.at[:, a_idx[lo:hi], a_idx[lo:hi] + o].add(row[:, lo:hi])
        if o < 0:  # rows a < -o spill into the subdiagonal block (col C+a+o)
            Asub = Asub.at[:, a_idx[:-o], a_idx[:-o] + C + o].add(row[:, :-o])
        elif o > 0:  # rows a >= C-o spill into the superdiagonal block
            Asup = Asup.at[:, a_idx[C - o :], a_idx[C - o :] - (C - o)].add(
                row[:, C - o :]
            )
    pad_rows = jnp.arange(npad).reshape(nb, C) >= n
    Aii = Aii + jax.vmap(jnp.diag)(pad_rows.astype(dtype))
    return Aii, Asub, Asup


def _flip2(M):
    return M[..., ::-1, ::-1]


# Both factorization scans are module-level jits (cached by shape) and force
# full-f32 matmul precision: a float32 product may otherwise run in TF32
# (about three decimal digits), which is catastrophic inside a direct
# factorization.


@jax.jit
def _device_cholesky(Aii, Asub):
    """Blocked Cholesky of a block-tridiagonal SPD matrix on device.

    Returns (Linv, Lsub): inv(L_ii) and L_{i,i-1}. NaNs signal a failed
    (non-SPD) factorization."""
    C = Aii.shape[-1]
    eye = jnp.eye(C, dtype=Aii.dtype)

    with jax.default_matmul_precision("float32"):

        def step(Linv_prev, inp):
            Aii_i, Asub_i = inp
            Lsub_i = Asub_i @ Linv_prev.T
            S = Aii_i - Lsub_i @ Lsub_i.T
            Lii = jnp.linalg.cholesky(S)
            Linv = jax.scipy.linalg.solve_triangular(Lii, eye, lower=True)
            return Linv, (Linv, Lsub_i)

        _, (Linv, Lsub) = lax.scan(
            step, jnp.zeros((C, C), Aii.dtype), (Aii, Asub)
        )
    return Linv, Lsub


@jax.jit
def _device_block_lu(Aii, Asub, Asup):
    """Blocked LU (block-tridiagonal, partial pivoting *within* diagonal
    blocks) on device. Returns (Dfwd, Lsub, Uinv, Usup):

      forward:  y_i = Dfwd_i @ (b_i - Lsub_i @ y_{i-1})   [Dfwd = inv(L_ii) P_i]
      backward: x_i = Uinv_i @ (y_i - Usup_i @ x_{i+1})
    """
    C = Aii.shape[-1]
    eye = jnp.eye(C, dtype=Aii.dtype)

    with jax.default_matmul_precision("float32"):

        def step(carry, inp):
            Uinv_prev, Usup_prev = carry
            Aii_i, Asub_i, Asup_i = inp
            Lsub_i = Asub_i @ Uinv_prev
            S = Aii_i - Lsub_i @ Usup_prev
            # lax.linalg.lu returns the *composed* row permutation (unlike
            # scipy-style lu_factor, whose piv is sequential LAPACK swaps)
            lu, _, perm = lax.linalg.lu(S)
            # S[perm] = L U; Dfwd = inv(L) P, so S^{-1} = Uinv @ Dfwd
            P = eye[perm]  # row-permutation matrix applied to rhs
            L = jnp.tril(lu, -1) + eye
            U = jnp.triu(lu)
            Dfwd_i = jax.scipy.linalg.solve_triangular(L, P, lower=True)
            Uinv_i = jax.scipy.linalg.solve_triangular(U, eye, lower=False)
            Usup_i = Dfwd_i @ Asup_i
            return (Uinv_i, Usup_i), (Dfwd_i, Lsub_i, Uinv_i, Usup_i)

        # derive the zero carry from the operand so its varying-axes type
        # matches the body outputs under shard_map (scan carry vma rule)
        z = Aii[0] * 0
        carry0 = (z, z)
        _, out = lax.scan(step, carry0, (Aii, Asub, Asup))
    return out


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _factorize_device_core(A, C, npad, nb, dtype, method, band_bw):
    """Whole device factorization (block extraction + scan + factor
    reshaping) as ONE jit: each eager op is a separate dispatch, and the
    flips/concats below would otherwise dominate setup time."""
    n = A.shape[0]
    Aii, Asub, Asup = _dia_to_block_tridiag(A, C, npad, nb, dtype)
    if method == "cholesky":
        Linv, Lsub = _device_cholesky(Aii, Asub)
        # bwd factor: reversed U = reversed L^T (see host path algebra):
        # dinvB[p] = flip2(Linv_q)^T, subB[p] = flip2(Lsub_{q+1}^T),
        # q = nb-1-p; subB[0] = 0.
        dinvB = _flip2(jnp.swapaxes(Linv, -1, -2))[::-1]
        subB_tail = _flip2(jnp.swapaxes(Lsub, -1, -2))[::-1]
        subB = jnp.concatenate([jnp.zeros((1, C, C), dtype), subB_tail[:-1]], axis=0)
        fwd = BandedFactor(dinv=Linv, sub=Lsub[:, None], nb=nb, C=C, k=1)
        bwd = BandedFactor(dinv=dinvB, sub=subB[:, None], nb=nb, C=C, k=1)
    else:  # 'lu' / 'auto'
        Dfwd, Lsub, Uinv, Usup = _device_block_lu(Aii, Asub, Asup)
        dinvB = _flip2(Uinv)[::-1]
        subB_tail = _flip2(Usup)[::-1]
        # reversed-system sub block p multiplies x block p-1 (original q+1):
        # T_{p,p-1} = flip2(U_{q,q+1}) with q = nb-1-p; first block has none
        subB = jnp.concatenate([jnp.zeros((1, C, C), dtype), subB_tail[1:]], axis=0)
        fwd = BandedFactor(dinv=Dfwd, sub=Lsub[:, None], nb=nb, C=C, k=1)
        bwd = BandedFactor(dinv=dinvB, sub=subB[:, None], nb=nb, C=C, k=1)
    kind = "cholesky" if method == "cholesky" else "lu"
    return BandedFactorization(
        fwd=fwd, bwd=bwd, n=n, npad=npad, stats=(band_bw, C, nb, kind)
    )


def factorize_banded_device(
    A,
    C: int = 256,
    dtype=None,
    method: str = "auto",
    validate: bool = False,
    verbose: int = 0,
) -> BandedFactorization:
    """Fully device-resident factorization of a banded DIA operator.

    ``method``: 'lu' (default for 'auto'; block LU with partial pivoting
    inside diagonal blocks — handles SPD and indefinite operators alike) or
    'cholesky' (SPD fast path; produces NaNs if the operator is not SPD).
    'auto' picks LU because choosing at runtime would need a device->host
    fetch mid-setup, which stalls the dispatch queue.

    ``validate``: fetch a NaN check after factorizing (one scalar; off by
    default for the same reason). The block size is raised to cover the
    bandwidth (block-tridiagonal requirement bw <= C)."""
    band_bw = max(abs(o) for o in A.offsets)
    n = A.shape[0]
    dtype = np.dtype(dtype) if dtype is not None else np.dtype(A.data.dtype)
    C = max(C, band_bw)
    nb = -(-n // C)
    npad = nb * C
    F = _factorize_device_core(
        A, C, npad, nb, dtype, "cholesky" if method == "cholesky" else "lu", band_bw
    )
    if validate:
        ok_arr = F.fwd.dinv[-1] if method == "cholesky" else F.bwd.dinv[0]
        if not bool(jnp.isfinite(ok_arr).all()):
            raise ZeroDivisionError(
                "device factorization failed "
                + ("(operator not SPD?)" if method == "cholesky" else "(zero pivot block?)")
            )
    if verbose > 0:
        print(
            f"factorize_banded_device: n={n} bw={band_bw} kind={F.stats[3]} C={C} nb={nb}"
        )
    return F


# ---------------------------------------------------------------------------
# Device-side solve: lax.scan of dense matmuls
# ---------------------------------------------------------------------------


def _scan_forward(F: BandedFactor, B_blocks: jax.Array) -> jax.Array:
    """Solve T x = b for lower block-banded T given partitioned-inverse
    blocks. B_blocks: (nb, C, m) -> x blocks (nb, C, m)."""
    k, C = F.k, F.C
    m = B_blocks.shape[-1]
    carry0 = jnp.zeros((k, C, m), B_blocks.dtype) + B_blocks[0, :1] * 0

    with jax.default_matmul_precision("float32"):

        def step(carry, inp):
            dinv_i, sub_i, b_i = inp
            acc = b_i - jnp.einsum(
                "jab,jbm->am", sub_i, carry, preferred_element_type=b_i.dtype
            )
            x_i = dinv_i @ acc
            new_carry = (
                jnp.concatenate([x_i[None], carry[:-1]], axis=0)
                if k > 1
                else x_i[None]
            )
            return new_carry, x_i

        _, X = lax.scan(step, carry0, (F.dinv, F.sub, B_blocks))
    return X


def banded_solve(F: BandedFactorization, B: jax.Array) -> jax.Array:
    """Multi-RHS A^{-1} B via the block-banded factors. Jittable; B: (n, m).

    Mirrors the reference pipeline (kernels_cpp.hh:660-755) minus the
    permutations — natural ordering needs none (P = Q = identity, Rs = 1)."""
    n, m = B.shape
    npad, C, nb = F.npad, F.fwd.C, F.fwd.nb
    pad = npad - n
    Bp = jnp.pad(B, ((0, pad), (0, 0))) if pad else B
    blocks = Bp.reshape(nb, C, m)
    Z = _scan_forward(F.fwd, blocks)  # L z = b
    # U x = z, solved on the reversed system over the full padded range
    # (the backward factor's padding rows are identity, so padded z rows
    # stay zero and decouple).
    Zr = Z.reshape(npad, m)[::-1].reshape(nb, C, m)
    Xr = _scan_forward(F.bwd, Zr)
    X = Xr.reshape(npad, m)[::-1]
    return X[:n]


_DEVICE_BW_MAX = 2048  # beyond this the (C, C) dense blocks stop paying off


_BANDED_SOLVE_FNS = {}


def _banded_solve_fn(refine: int):
    """Memoized per-``refine`` solve function: the solver cores key their
    jit cache on the *identity* of the inverse function (static arg), so a
    fresh closure per factory call would force a full retrace + compile on
    every solve."""
    if refine not in _BANDED_SOLVE_FNS:
        from dune_eigensolver_tpu.sparse.spmm import spmm

        def solve(aux, X, _refine=refine):
            F_, A_ = aux
            Y = banded_solve(F_, X).astype(X.dtype)
            for _ in range(_refine):
                Y = Y + banded_solve(F_, X - spmm(A_, Y)).astype(X.dtype)
            return Y

        _BANDED_SOLVE_FNS[refine] = solve
    return _BANDED_SOLVE_FNS[refine]


def banded_inverse_factory(A_sh, C: int = 256, refine: int = 1, **kw):
    """``inverse=`` factory for the solvers: factorize once (on device when
    the bandwidth allows, else on the host) and return the closure-free pair
    ``(aux, fn)`` with ``fn(aux, X) = A^-1 X`` (reference: factorize once at
    eigensolver.hh:156,256, apply every iteration).

    The pair convention matters: the factors are O(n*C) bytes, and a
    callable closing over them would embed them as XLA constants in every
    downstream trace. The solvers thread ``aux`` through jit as a real
    argument instead.

    ``refine``: iterative-refinement steps per apply (x += F(b - A x)).
    One step costs a DIA SpMM + one trisolve and recovers the accuracy a
    low-precision factorization loses — the mixed-precision analogue of the
    reference's full-f64 UMFPACK solve."""
    bw = max(abs(o) for o in A_sh.offsets)
    if bw <= _DEVICE_BW_MAX:
        F = factorize_banded_device(A_sh, C=C, **kw)
    else:
        F = factorize_banded(A_sh, C=C, **kw)
    return (F, A_sh), _banded_solve_fn(refine)
