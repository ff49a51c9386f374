"""Row-partitioned GENERAL-sparsity execution: per-shard ELL SpMM under
``shard_map``.

dist/sharded.py distributes the structured (DIA) operand class; this module
extends the distributed layer to the reference's native operand class —
arbitrary CSR/BCRS patterns (kernels_cpp.hh:626-657). The reference itself
has no distributed execution at all (MPI deliberately disabled,
src/dune-eigensolver.cc:742-748).

Design:

* rows are split into P equal shards; after an RCM-style ordering the
  pattern's bandwidth ``halo = max |col - row|`` is bounded, so a shard's
  SpMM needs only its neighbors' boundary rows — the same
  ``lax.ppermute`` halo exchange as the DIA path (``halo_exchange_t``).
* each shard's rows become a plain ELL over its halo-extended column
  window ``[r0 - halo, r1 + halo)`` (edge shards read the zero fill
  ppermute provides).
* shard_map needs one static shape for every shard, so the row length is
  the maximum over the shards, and the per-shard arrays are stacked on a
  leading shard axis that ``in_specs`` splits.
* the hot loop inside shard_map is then: halo exchange -> ``ell_spmm_t``
  (sparse/spmm.py). Gram reductions psum as usual.

Any ``n`` is accepted: ``windowed_shard_plan`` pads non-divisible row
counts host-side with decoupled identity/zero diagonal rows (the DIA
drivers' convention — pad lanes stay exactly zero). ``windowed_spmm_halo_t``
overlaps the ppermute with the interior rows by default: the ELL reads only
local columns (the halo slabs are zero-filled), so it has no data
dependence on the collective, and two small dense boundary blocks alone
consume the exchanged slabs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dune_eigensolver_tpu.dist.mesh import ROW_AXIS, make_mesh
from dune_eigensolver_tpu.dist.sharded import (
    _cached_program,
    _mesh_key,
    _result_specs,
    _slice_result,
    halo_exchange_t,
    psum_reduce,
)
from dune_eigensolver_tpu.sparse.formats import (
    BSRMatrix,
    DIAMatrix,
    ELLMatrix,
    ell_from_scipy,
)
from dune_eigensolver_tpu.sparse.spmm import ell_spmm_t


@dataclasses.dataclass(frozen=True)
class WindowedShardPlan:
    """P per-shard ELL blocks over each shard's halo-extended column
    window, with one row length, stacked on a leading shard axis (split by
    shard_map in_specs).

    ``bnd_left``/``bnd_right`` are dense (halo, halo) boundary blocks per
    shard — the entries whose columns land in the exchanged halo slabs — so
    the ELL can run on local-only X (overlappable with the ppermute) while
    the boundary contributions ride two small matmuls that alone consume
    the collective's output. Zero-size when halo == 0 or the halo exceeds
    ``_BND_DENSE_CAP`` (drivers then serialize exchange -> SpMM)."""

    data: jax.Array  # (P, nloc, k)
    cols: jax.Array  # (P, nloc, k) int32, extended-window columns
    bnd_left: jax.Array  # (P, halo, halo) or (P, 0, 0)
    bnd_right: jax.Array  # (P, halo, halo) or (P, 0, 0)
    shape: Tuple[int, int]  # static per-shard logical (nloc, nloc + 2 halo)
    nnz: int  # max per-shard nnz
    halo: int
    nloc: int
    n: int  # global rows AFTER pad (nloc * P)
    n_logical: int = -1  # original rows; -1 = same as n (no pad)
    band_data: jax.Array = None  # (P, ndiag, nloc) local diag block, or (P, 0, 1)
    band_offsets: Tuple[int, ...] = ()  # static DIA offsets of band_data

    @property
    def k(self) -> int:
        return self.data.shape[-1]

    @property
    def rows(self) -> int:
        """Original (pre-pad) global row count."""
        return self.n if self.n_logical < 0 else self.n_logical


jax.tree_util.register_dataclass(
    WindowedShardPlan,
    data_fields=["data", "cols", "bnd_left", "bnd_right", "band_data"],
    meta_fields=["shape", "nnz", "halo", "nloc", "n", "n_logical",
                 "band_offsets"],
)

# dense boundary blocks cost 4 * halo^2 bytes per side per shard; past this
# the overlap machinery costs more memory than it hides and the drivers fall
# back to the serialized exchange -> SpMM order (correct either way).
_BND_DENSE_CAP = 2048


def _to_scipy(A):
    if isinstance(A, (ELLMatrix, BSRMatrix, DIAMatrix)):
        return A.to_scipy().tocsr()
    import scipy.sparse as sp

    if sp.issparse(A):
        return A.tocsr()
    raise TypeError(f"windowed_shard_plan: unsupported operand {type(A)}")


def windowed_shard_plan(
    A, P_shards: int, diag_fill: float = 1.0, local_band: bool = False,
) -> WindowedShardPlan:
    """Host-side planning: split the rows, build each shard's ELL over its
    extended column window, pad to one row length, stack.

    ``n % P_shards != 0`` is handled by DECOUPLED host-side pad rows:
    ``diag_fill`` on the diagonal (1.0 for operators so pad lanes are
    well-conditioned, 0.0 for mass matrices — the DIA drivers' convention,
    sharded.py ``_pad_rows_dia``), zero coupling to real rows. With a
    zero start vector the pad lanes stay exactly zero through every linear
    operation, so the spectrum is untouched; the reference accepts any n
    at every entry point (eigensolver.hh:28,116,204)."""
    import scipy.sparse as sp

    S = _to_scipy(A)
    n_logical = n = S.shape[0]
    if S.shape[0] != S.shape[1]:
        raise ValueError("windowed_shard_plan: operator must be square")
    if n % P_shards != 0:
        n_pad = -(-n // P_shards) * P_shards
        coo0 = S.tocoo()
        rows_, cols_, vals_ = coo0.row, coo0.col, coo0.data
        if diag_fill != 0.0:
            pr = np.arange(n, n_pad)
            rows_ = np.concatenate([rows_, pr])
            cols_ = np.concatenate([cols_, pr])
            vals_ = np.concatenate(
                [vals_, np.full(n_pad - n, diag_fill, dtype=vals_.dtype)]
            )
        S = sp.coo_matrix(
            (vals_, (rows_, cols_)), shape=(n_pad, n_pad)
        ).tocsr()
        n = n_pad
    nloc = n // P_shards
    coo = S.tocoo()
    halo = int(np.abs(coo.col - coo.row).max()) if coo.nnz else 0
    if halo > nloc:
        raise ValueError(
            f"windowed_shard_plan: bandwidth {halo} exceeds local rows "
            f"{nloc}; use fewer shards or reorder (RCM) first"
        )
    next_ = nloc + 2 * halo

    dtype = np.dtype(S.dtype)
    bh = halo if 0 < halo <= _BND_DENSE_CAP else 0
    bnd_l = np.zeros((P_shards, bh, bh), dtype)
    bnd_r = np.zeros((P_shards, bh, bh), dtype)
    blocks = []
    for i in range(P_shards):
        r0 = i * nloc
        Sl = S[r0 : r0 + nloc, :].tocoo()
        # shift to the halo-extended local column space; all entries land
        # in [0, next_) because |col - row| <= halo
        cols_ext = Sl.col - (r0 - halo)
        Sl_ext = sp.coo_matrix(
            (Sl.data, (Sl.row, cols_ext)), shape=(nloc, next_)
        ).tocsr()
        if bh:
            # dense boundary blocks for the overlapped SpMM: rows that read
            # the left/right exchanged halo slabs (bandwidth bound => only
            # the first/last ``halo`` local rows can)
            bnd_l[i] = Sl_ext[:bh, :bh].toarray()
            bnd_r[i] = Sl_ext[nloc - bh :, halo + nloc :].toarray()
        blocks.append(Sl_ext)
    k = max(int(np.diff(b.indptr).max()) if nloc else 0 for b in blocks)
    ells = [ell_from_scipy(b, dtype=dtype, k=max(k, 1)) for b in blocks]
    data = np.stack([np.asarray(e.data) for e in ells])
    cols = np.stack([np.asarray(e.cols) for e in ells])

    if halo > _BND_DENSE_CAP:
        from dune_eigensolver_tpu.utils.vlog import warn_fallback

        warn_fallback(
            f"windowed_shard_plan: halo {halo} > {_BND_DENSE_CAP} — dense "
            "boundary blocks skipped, halo exchange will serialize before "
            "the SpMM (no collective/compute overlap on this operand)"
        )

    # shard-local diagonal-block band (Schwarz inner engine): the post-RCM
    # bandwidth bound means each shard's nloc x nloc diagonal block is
    # banded with bw <= halo, so the device block-banded factorization
    # (factorize/banded.py) applies per shard — the same exact-local-solve
    # preconditioner the DIA dist layer has (sharded.schwarz_inverse_t)
    band_offsets: Tuple[int, ...] = ()
    band_data = np.zeros((P_shards, 0, 1), dtype)
    if local_band:
        from dune_eigensolver_tpu.factorize.banded import _DEVICE_BW_MAX
        from dune_eigensolver_tpu.sparse.formats import dia_from_scipy

        if halo > _DEVICE_BW_MAX:
            from dune_eigensolver_tpu.utils.vlog import warn_fallback

            warn_fallback(
                f"windowed_shard_plan: local bandwidth {halo} > "
                f"{_DEVICE_BW_MAX} — no per-shard banded block "
                "(Schwarz inner unavailable; use inner='cg')"
            )
        else:
            locals_ = [
                dia_from_scipy(
                    S[i * nloc : (i + 1) * nloc, i * nloc : (i + 1) * nloc],
                    dtype=dtype,
                )
                for i in range(P_shards)
            ]
            union = sorted(set().union(*(set(L.offsets) for L in locals_)))
            band_data = np.zeros((P_shards, len(union), nloc), dtype)
            pos = {o: j for j, o in enumerate(union)}
            for i, L in enumerate(locals_):
                for j, o in enumerate(L.offsets):
                    band_data[i, pos[o]] = np.asarray(L.data[j])
            band_offsets = tuple(union)

    return WindowedShardPlan(
        data=jnp.asarray(data),
        cols=jnp.asarray(cols),
        bnd_left=jnp.asarray(bnd_l),
        bnd_right=jnp.asarray(bnd_r),
        band_data=jnp.asarray(band_data),
        band_offsets=band_offsets,
        shape=(nloc, next_),
        nnz=max(int(b.nnz) for b in blocks),
        halo=halo,
        nloc=nloc,
        n=n,
        n_logical=n_logical,
    )


def _shard_container(plan: WindowedShardPlan, arrs) -> ELLMatrix:
    """This shard's ELL from the traced per-shard slices (leading shard
    axis already split by in_specs)."""
    data, cols = arrs[:2]
    return ELLMatrix(data=data[0], cols=cols[0], shape=plan.shape,
                     nnz=plan.nnz)


def windowed_spmm_halo_t(
    plan: WindowedShardPlan,
    op: ELLMatrix,
    x_local: jax.Array,
    axis: str = ROW_AXIS,
    bnd: Optional[Tuple[jax.Array, jax.Array]] = None,
) -> jax.Array:
    """Local rows of ``(A @ X)^T`` for the row-sharded general operand.
    x_local: (m, nloc).

    With ``bnd`` (this shard's dense boundary blocks): OVERLAPPED form —
    the ppermute is issued first, the ELL SpMM reads ONLY local columns
    (halo slabs zero-filled, so it has no data dependence on the
    collective and XLA's scheduler can run both concurrently), and the
    exchanged slabs feed two (m, halo) x (halo, halo) matmuls that correct
    the first/last ``halo`` rows — the general-sparsity analogue of the
    DIA path's interior/edge split (``padded_spmm_halo``). Without
    ``bnd``: the serialized order (exchange completes before the SpMM)."""
    halo = plan.halo
    if halo == 0 or bnd is None:
        return ell_spmm_t(op, halo_exchange_t(x_local, halo, axis))
    from jax import lax

    m, nloc = x_local.shape
    ndev = lax.axis_size(axis)
    if ndev > 1:  # launch the exchange first; the SpMM never reads it
        fwd = [(i, i + 1) for i in range(ndev - 1)]
        bwd = [(i + 1, i) for i in range(ndev - 1)]
        from_left = lax.ppermute(x_local[:, -halo:], axis, fwd)
        from_right = lax.ppermute(x_local[:, :halo], axis, bwd)
    else:
        from_left = jnp.zeros((m, halo), x_local.dtype)
        from_right = jnp.zeros((m, halo), x_local.dtype)
    Y = ell_spmm_t(op, jnp.pad(x_local, ((0, 0), (halo, halo))))
    A_l, A_r = bnd
    hp = jax.lax.Precision.HIGHEST  # no TF32 for float32 operands
    Y = Y.at[:, :halo].add(jnp.matmul(from_left, A_l.T, precision=hp))
    Y = Y.at[:, nloc - halo :].add(
        jnp.matmul(from_right, A_r.T, precision=hp)
    )
    return Y


def _shard_diag(plan: WindowedShardPlan, op: ELLMatrix) -> jax.Array:
    """(nloc,) main diagonal of this shard's local block: in the extended
    column space the diagonal of local row i sits at column i + halo."""
    own = jnp.arange(plan.nloc, dtype=op.cols.dtype)[:, None] + plan.halo
    return jnp.sum(jnp.where(op.cols == own, op.data, 0), axis=1)


def _q0_general(seed, plan, m, dtype, mesh, axis):
    """Sharded transposed start block: random over the LOGICAL rows, pad
    lanes exactly zero (the decoupled-pad-row invariant — sharded.py
    ``_random_q0_t``)."""
    from dune_eigensolver_tpu.solvers.standard import random_multivector_t

    Q0 = random_multivector_t(jax.random.PRNGKey(seed), plan.rows, m, dtype)
    if plan.n != plan.rows:
        Q0 = jnp.pad(Q0, ((0, 0), (0, plan.n - plan.rows)))
    return jax.device_put(Q0, NamedSharding(mesh, P(None, axis)))


_N_PLAN_ARRS = 4


def _plan_arrays(plan):
    return (plan.data, plan.cols, plan.bnd_left, plan.bnd_right)


def _plan_specs(axis):
    return tuple(P(axis, None, None) for _ in range(_N_PLAN_ARRS))


def _shard_bnd(plan: WindowedShardPlan, arrs):
    """This shard's dense boundary blocks, or None when overlap is
    unavailable (halo == 0 or past ``_BND_DENSE_CAP``)."""
    bl, br = arrs[2], arrs[3]
    if bl.shape[-1] == 0 or plan.halo == 0:
        return None
    return (bl[0], br[0])


def largest_operator(A, shift: float = 0.0):
    """The (shifted) operator ``sharded_standard_largest_general`` plans:
    prebuild its plan once with ``windowed_shard_plan(largest_operator(A,
    shift), P)`` and pass it as ``plan=`` to amortize host planning +
    device upload across repeated solves."""
    S = _to_scipy(A)
    if shift != 0.0:
        import scipy.sparse as sp

        S = (S + shift * sp.eye(S.shape[0], dtype=S.dtype)).tocsr()
    return S


def pencil_operator(A, B, shift: float = 0.0, reg: float = 0.0):
    """The shift-folded pencil operator the generalized/lobpcg general
    drivers plan (A + shift*B + reg*I); see ``largest_operator``."""
    import scipy.sparse as sp

    S = _to_scipy(A)
    Sb = None if B is None else _to_scipy(B)
    n = S.shape[0]
    if shift != 0.0:
        S = S + shift * (sp.eye(n, dtype=S.dtype) if Sb is None else Sb)
    if reg != 0.0:
        S = S + reg * sp.eye(n, dtype=S.dtype)
    return S.tocsr()


def sharded_standard_largest_general(
    A,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    mesh: Optional[Mesh] = None,
    block: int = 8,
    seed: int = 123,
    ortho_iterations: int = 1,
    rayleigh_ritz: bool = False,
    axis: str = ROW_AXIS,
    plan: Optional[WindowedShardPlan] = None,
):
    """Multi-device ``standard_largest`` on a GENERAL (ELL/BSR/scipy)
    operand through the per-shard ELL SpMM. Same semantics as the DIA
    driver; ``shift`` is applied host-side into the plan. ``plan``: a
    prebuilt ``windowed_shard_plan(largest_operator(A, shift), ndev)`` —
    after its first use the plan's arrays are device-resident, so repeated
    solves skip the host re-plan + re-upload (the dominant per-solve cost
    on small operands)."""
    from dune_eigensolver_tpu.solvers.standard import (
        _largest_core,
        padded_width,
    )

    mesh = mesh or make_mesh(axis=axis)
    ndev = int(mesh.shape[axis])
    m = padded_width(nev, block)
    if plan is None:
        # plans memoized on the operand's identity (weakref-evicted —
        # engine.memoized_setup): re-solving the same operand must not
        # re-plan host-side and re-upload the plan arrays
        from dune_eigensolver_tpu.solvers.engine import memoized_setup

        plan = memoized_setup(
            (A,),
            ("win_plan_largest", ndev, float(shift)),
            lambda: windowed_shard_plan(largest_operator(A, shift), ndev),
        )
    if plan.nloc * ndev != plan.n:
        raise ValueError("plan does not match the mesh size")
    n = plan.n
    op_dtype = np.dtype(plan.data.dtype)
    Q0 = _q0_general(seed, plan, m, op_dtype, mesh, axis)
    reduce_ = psum_reduce(axis)

    def local_solver(q0, *arrs):
        op = _shard_container(plan, arrs)
        bnd = _shard_bnd(plan, arrs)
        apply_a = lambda X: windowed_spmm_halo_t(  # noqa: E731
            plan, op, X, axis=axis, bnd=bnd
        )
        cfg = (
            nev, float(tol), int(maxiter), float(shift), int(block),
            int(ortho_iterations), bool(rayleigh_ritz), int(n),
            jnp.dtype(op_dtype),
        )
        return _largest_core(None, q0, (apply_a, reduce_), cfg)

    key = (
        "largest_general", _mesh_key(mesh), axis, plan.shape, plan.k,
        plan.nnz, plan.halo, nev, float(tol),
        int(maxiter), float(shift), int(block), int(ortho_iterations),
        bool(rayleigh_ritz), str(op_dtype), m,
    )
    fn = _cached_program(
        key,
        lambda: jax.jit(
            jax.shard_map(
                local_solver,
                mesh=mesh,
                in_specs=(P(None, axis),) + _plan_specs(axis),
                out_specs=_result_specs(axis),
                check_vma=False,
            )
        ),
    )
    return _slice_result(fn(Q0, *_plan_arrays(plan)), plan.rows)


def sharded_lobpcg_general(
    A,
    B=None,
    nev: int = 8,
    tol: float = 2e-3,
    maxiter: int = 200,
    shift: float = 1e-3,
    reg: float = 0.0,
    mesh: Optional[Mesh] = None,
    block: int = 8,
    seed: int = 123,
    min_iter: int = 3,
    ortho_eps: float = 1e-9,
    cg_rtol: float = 1e-2,
    cg_maxiter: int = 50,
    axis: str = ROW_AXIS,
    ortho_block=None,
    plans: Optional[Tuple] = None,
    precond: str = "cg",
):
    """Multi-device preconditioned LOBPCG (smallest eigenpairs) on a GENERAL
    operand pair. ``B=None`` means the identity pencil (standard problem);
    otherwise B is planned onto the same sharding and applied through the
    per-shard ELL SpMM too. Preconditioner (``precond``): 'cg' = per-shard
    Jacobi-CG on the shifted operator (loose, matrix-free); 'schwarz' =
    ONE exact per-shard banded block solve per apply (the additive-Schwarz
    approximate inverse — LOBPCG only needs a search direction, so the CG
    wrapper the shift-invert drivers use is unnecessary here; auto-falls
    back to 'cg' past the device bandwidth ceiling). Gram reductions psum
    over the mesh. ``plans``: prebuilt ``(plan_a, plan_b)`` — plan_a over
    ``pencil_operator(A, B, shift, reg)`` (and ``local_band=True`` for
    'schwarz'), plan_b over B with
    ``diag_fill=0.0`` (or None for the identity pencil); reuse amortizes
    host planning + upload across solves."""
    from dune_eigensolver_tpu.factorize.cg import cg_solve_t
    from dune_eigensolver_tpu.solvers.lobpcg import _lobpcg_core
    from dune_eigensolver_tpu.solvers.standard import padded_width

    if precond not in ("cg", "schwarz"):
        raise ValueError(f"unknown precond {precond!r} (cg|schwarz)")
    mesh = mesh or make_mesh(axis=axis)
    ndev = int(mesh.shape[axis])
    m = padded_width(nev, block)
    if plans is not None:
        plan_a, plan_b = plans
    else:
        # plans memoized on the operand identities (weakref-evicted):
        # re-solving the same pencil must not re-plan host-side and
        # re-upload — with local_band the band alone is O(bw * nloc)
        from dune_eigensolver_tpu.solvers.engine import memoized_setup

        def _build_plans():
            S_op = pencil_operator(A, B, shift, reg)
            pa = windowed_shard_plan(
                S_op, ndev, local_band=(precond == "schwarz"),
            )
            pb = (
                None
                if B is None
                else windowed_shard_plan(_to_scipy(B), ndev, diag_fill=0.0)
            )
            return pa, pb

        plan_a, plan_b = memoized_setup(
            (A,) if B is None else (A, B),
            ("win_plan_lobpcg", ndev, float(shift), float(reg), precond),
            _build_plans,
        )
    if precond == "schwarz" and not plan_a.band_offsets:
        precond = "cg"  # plan already warned (bandwidth > device ceiling)
    n = plan_a.n  # padded global rows (pad lanes stay exactly zero)
    op_dtype = np.dtype(plan_a.data.dtype)
    Q0 = _q0_general(seed, plan_a, m, op_dtype, mesh, axis)
    reduce_ = psum_reduce(axis)

    def local_solver(q0, *arrs):
        op_a = _shard_container(plan_a, arrs)
        bnd_a = _shard_bnd(plan_a, arrs)
        apply_a = lambda X: windowed_spmm_halo_t(  # noqa: E731
            plan_a, op_a, X, axis=axis, bnd=bnd_a
        )
        if plan_b is None:
            apply_b = lambda X: X  # noqa: E731
        else:
            arrs_b = arrs[_N_PLAN_ARRS:]
            op_b = _shard_container(plan_b, arrs_b)
            bnd_b = _shard_bnd(plan_b, arrs_b)
            apply_b = lambda X: windowed_spmm_halo_t(  # noqa: E731
                plan_b, op_b, X, axis=axis, bnd=bnd_b
            )
        inv_diag = 1.0 / _shard_diag(plan_a, op_a)

        if precond == "schwarz":
            from dune_eigensolver_tpu.factorize.banded import (
                banded_solve,
                factorize_banded_device,
            )
            from dune_eigensolver_tpu.sparse.formats import DIAMatrix

            nb = _N_PLAN_ARRS * (1 if plan_b is None else 2)
            blk = DIAMatrix(
                data=arrs[nb][0],
                offsets=plan_a.band_offsets,
                shape=(plan_a.nloc, plan_a.nloc),
            )
            F = factorize_banded_device(blk)

            def prec_fn(_aux, X):  # one exact local block solve per apply
                return banded_solve(F, X.T).T

        else:

            def prec_fn(_aux, X):
                Y, _ = cg_solve_t(
                    apply_a, X, inv_diag=inv_diag, rtol=cg_rtol,
                    maxiter=cg_maxiter, gram_reduce=reduce_,
                )
                return Y

        cfg = (
            nev, float(tol), int(maxiter), float(shift), int(block),
            int(min_iter), float(ortho_eps), int(n),
            jnp.dtype(op_dtype), 2, ortho_block,
        )
        hooks = (apply_a, apply_b, reduce_, prec_fn)
        return _lobpcg_core(None, None, None, q0, hooks, cfg)

    key = (
        "lobpcg_general", _mesh_key(mesh), axis, plan_a.shape, plan_a.k,
        plan_a.nnz, plan_a.halo,
        # plan_b's halo is baked statically into the traced halo exchange
        None if plan_b is None else (plan_b.shape, plan_b.k, plan_b.nnz,
                                     plan_b.halo),
        nev, float(tol), int(maxiter), float(shift), float(reg), int(block),
        int(min_iter), float(ortho_eps), float(cg_rtol), int(cg_maxiter),
        ortho_block, str(op_dtype), m,
        precond, plan_a.band_offsets,
    )
    b_arrs = () if plan_b is None else _plan_arrays(plan_b)
    if precond == "schwarz":
        b_arrs = b_arrs + (plan_a.band_data,)
    fn = _cached_program(
        key,
        lambda: jax.jit(
            jax.shard_map(
                local_solver,
                mesh=mesh,
                in_specs=(P(None, axis),)
                + _plan_specs(axis)
                + (_plan_specs(axis) if plan_b is not None else ())
                + ((P(axis, None, None),) if precond == "schwarz" else ()),
                out_specs=_result_specs(axis),
                check_vma=False,
            )
        ),
    )
    return _slice_result(fn(Q0, *_plan_arrays(plan_a), *b_arrs), plan_a.rows)


def sharded_generalized_inverse_general(
    A,
    B,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    reg: float = 0.0,
    mesh: Optional[Mesh] = None,
    block: int = 8,
    seed: int = 123,
    min_iter: int = 10,
    ortho_iterations: int = 1,
    rayleigh_ritz: bool = False,
    cg_rtol: float = 1e-6,
    cg_maxiter: int = 2000,
    axis: str = ROW_AXIS,
    inner: str = "schwarz",
    plans: Optional[Tuple] = None,
):
    """Multi-device ``generalized_inverse`` (shift-invert subspace
    iteration) on a GENERAL operand pair through the per-shard ELL SpMM.
    ``plans``:
    prebuilt ``(plan_a, plan_b)`` — plan_a over ``pencil_operator(A, B,
    shift, reg)`` (with ``local_band=True`` for ``inner='schwarz'``),
    plan_b over B with ``diag_fill=0.0``; reuse amortizes host planning +
    device upload across solves.

    ``inner='schwarz'`` (default): the global CG on the shifted operator is
    preconditioned by EXACT per-shard banded block solves — post-RCM
    general patterns have bounded bandwidth, so each shard's diagonal block
    factorizes on the device block-banded engine (factorize/banded.py),
    matching the DIA drivers (sharded.schwarz_inverse_t). Auto-downgrades to
    ``inner='cg'`` (plain Jacobi-CG) with a loud FALLBACK when the
    bandwidth exceeds the device engine's ceiling."""
    from dune_eigensolver_tpu.factorize.cg import cg_solve_t
    from dune_eigensolver_tpu.solvers.generalized import _gen_core
    from dune_eigensolver_tpu.solvers.standard import padded_width

    if inner not in ("schwarz", "cg"):
        raise ValueError(f"unknown inner engine {inner!r} (schwarz|cg)")
    mesh = mesh or make_mesh(axis=axis)
    ndev = int(mesh.shape[axis])
    m = padded_width(nev, block)
    if plans is not None:
        plan_a, plan_b = plans
    else:
        # plans memoized on the operand identities (see lobpcg above)
        from dune_eigensolver_tpu.solvers.engine import memoized_setup

        def _build_plans():
            S_op = pencil_operator(A, B, shift, reg)
            pa = windowed_shard_plan(
                S_op, ndev, local_band=(inner == "schwarz"),
            )
            pb = windowed_shard_plan(_to_scipy(B), ndev, diag_fill=0.0)
            return pa, pb

        plan_a, plan_b = memoized_setup(
            (A, B),
            ("win_plan_gen", ndev, float(shift), float(reg), inner),
            _build_plans,
        )
    if inner == "schwarz" and not plan_a.band_offsets:
        inner = "cg"  # plan already warned (bandwidth > device ceiling)
    n = plan_a.n  # padded global rows (pad lanes stay exactly zero)
    op_dtype = np.dtype(plan_a.data.dtype)
    Q0 = _q0_general(seed, plan_a, m, op_dtype, mesh, axis)
    reduce_ = psum_reduce(axis)

    def local_solver(q0, *arrs):
        arrs_b = arrs[_N_PLAN_ARRS : 2 * _N_PLAN_ARRS]
        op_a = _shard_container(plan_a, arrs)
        op_b = _shard_container(plan_b, arrs_b)
        bnd_a = _shard_bnd(plan_a, arrs)
        bnd_b = _shard_bnd(plan_b, arrs_b)
        apply_a = lambda X: windowed_spmm_halo_t(  # noqa: E731
            plan_a, op_a, X, axis=axis, bnd=bnd_a
        )
        apply_b = lambda X: windowed_spmm_halo_t(  # noqa: E731
            plan_b, op_b, X, axis=axis, bnd=bnd_b
        )
        inv_diag = 1.0 / _shard_diag(plan_a, op_a)

        if inner == "schwarz":
            from dune_eigensolver_tpu.factorize.banded import (
                banded_solve,
                factorize_banded_device,
            )
            from dune_eigensolver_tpu.sparse.formats import DIAMatrix

            blk = DIAMatrix(
                data=arrs[2 * _N_PLAN_ARRS][0],
                offsets=plan_a.band_offsets,
                shape=(plan_a.nloc, plan_a.nloc),
            )
            F = factorize_banded_device(blk)

            def precond(R):  # exact per-shard banded block solve
                return banded_solve(F, R.T).T

            if ndev == 1:
                # the local block IS the global operator: the Schwarz
                # preconditioner is exact and the CG wrapper would burn
                # >= 2 banded solves per apply verifying it
                def inv_fn(_aux, X):
                    return precond(X)

            else:

                def inv_fn(_aux, X):
                    Y, _ = cg_solve_t(
                        apply_a, X, rtol=cg_rtol, maxiter=cg_maxiter,
                        gram_reduce=reduce_, precond_apply=precond,
                    )
                    return Y

        else:

            def inv_fn(_aux, X):
                Y, _ = cg_solve_t(
                    apply_a, X, inv_diag=inv_diag, rtol=cg_rtol,
                    maxiter=cg_maxiter, gram_reduce=reduce_,
                )
                return Y

        cfg = (
            nev, float(tol), int(maxiter), float(shift), int(block),
            int(min_iter), int(ortho_iterations), bool(rayleigh_ritz),
            int(n), jnp.dtype(op_dtype),
        )
        hooks = (apply_a, apply_b, reduce_, inv_fn)
        return _gen_core(None, None, None, q0, hooks, cfg)

    key = (
        "generalized_general", _mesh_key(mesh), axis,
        plan_a.shape, plan_a.k, plan_a.nnz, plan_a.halo,
        plan_b.shape, plan_b.k, plan_b.nnz, plan_b.halo, nev,
        float(tol), int(maxiter), float(shift), float(reg), int(block),
        int(min_iter), int(ortho_iterations), bool(rayleigh_ritz),
        float(cg_rtol), int(cg_maxiter), str(op_dtype), m,
        inner, plan_a.band_offsets,
    )
    band_args = (plan_a.band_data,) if inner == "schwarz" else ()
    band_specs = (
        (P(axis, None, None),) if inner == "schwarz" else ()
    )
    fn = _cached_program(
        key,
        lambda: jax.jit(
            jax.shard_map(
                local_solver,
                mesh=mesh,
                in_specs=(P(None, axis),)
                + _plan_specs(axis)
                + _plan_specs(axis)
                + band_specs,
                out_specs=_result_specs(axis),
                check_vma=False,
            )
        ),
    )
    return _slice_result(
        fn(Q0, *_plan_arrays(plan_a), *_plan_arrays(plan_b), *band_args),
        plan_a.rows,
    )
