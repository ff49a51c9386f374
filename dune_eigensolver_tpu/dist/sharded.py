"""Row-partitioned multi-chip execution: halo-exchange SpMM, allreduce
orthogonalization, and sharded solver drivers.

This is the distributed layer the reference deliberately does not have (MPI
startup is commented out with "DO NOT INITIALIZE MPI", src/
dune-eigensolver.cc:742-748; its only concurrency is benchmark-replica
threads). Here:

* the matrix (DIA) and multivector rows are sharded over a 1D mesh axis;
  every shard holds the TRANSPOSED local block (m, nloc), the single-device
  solvers' layout;
* the hot-loop SpMM runs the SAME guarded-layout SpMM as the single-device
  engine on a PER-SHARD guarded layout (``padded_spmm_halo``): the interior
  sweep is ``kernels.dia_spmm.padded_spmm`` on the local block and only the
  O(halo) edge lanes consume the ``lax.ppermute`` halo slabs. The plain
  slice formulation is ``spmm='xla'``; ``backend.dia_spmm_mode()`` picks
  the default;
* SpMM needs off-shard X rows up to the bandwidth: neighbors exchange halo
  slabs via ``lax.ppermute`` (non-cyclic, so edge shards receive zeros —
  exactly the Dirichlet zero-padding the local kernel expects), with the
  interior sweep independent of the collective (overlap-friendly);
* every Gram matrix / dot product / convergence reduction becomes one
  ``lax.psum`` (the ``gram_reduce`` hook threaded through ops/ and solvers/);
* the entire solver while-loop runs inside one ``shard_map``, so an N-card
  solve is a single XLA computation whose collectives XLA hands to NCCL;
* row counts that do not divide the mesh size are padded with decoupled
  identity rows (unit diagonal, zero coupling, zero start vector — the pad
  lanes stay EXACTLY zero through every linear operation, so the spectrum
  is untouched); the reference accepts any n (BCRS is unconstrained), and
  so do these drivers.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dune_eigensolver_tpu.dist.mesh import ROW_AXIS, make_mesh
from dune_eigensolver_tpu.kernels.dia_spmm import (
    PaddedDIA,
    PaddedLayout,
    padded_spmm,
)
from dune_eigensolver_tpu.sparse.formats import DIAMatrix


def halo_exchange_t(x_local: jax.Array, halo: int, axis: str = ROW_AXIS):
    """Gather ``halo`` boundary lanes from each neighbor.

    x_local: (m, nloc). Returns x_ext of shape (m, halo + nloc + halo).
    Edge shards get zeros in the missing direction (lax.ppermute
    semantics), matching the zero padding of the single-chip DIA SpMM.
    """
    if halo == 0:
        # diagonal-only operand: nothing to exchange. Without this guard
        # ``x_local[:, -0:]`` selects the WHOLE array and the concatenate
        # below builds a 3*nloc-wide x_ext (ADVICE r4).
        return x_local
    ndev = lax.axis_size(axis)
    if ndev == 1:
        pad = jnp.zeros(x_local.shape[:1] + (halo,), x_local.dtype)
        return jnp.concatenate([pad, x_local, pad], axis=1)
    fwd = [(i, i + 1) for i in range(ndev - 1)]  # my top rows -> right's left halo
    bwd = [(i + 1, i) for i in range(ndev - 1)]
    from_left = lax.ppermute(x_local[:, -halo:], axis, fwd)
    from_right = lax.ppermute(x_local[:, :halo], axis, bwd)
    return jnp.concatenate([from_left, x_local, from_right], axis=1)


def dia_spmm_halo_t(
    data_local: jax.Array,
    offsets: tuple,
    x_local: jax.Array,
    axis: str = ROW_AXIS,
) -> jax.Array:
    """Local rows of ``(A @ X)^T`` for a row-sharded DIA matrix — the XLA
    slice formulation (``spmm='xla'``). Transposed layout throughout.

    data_local: (ndiag, nloc) — this shard's rows of every diagonal.
    x_local: (m, nloc). Requires halo = max|offset| <= nloc.

    The interior FMA sweep consumes only local lanes (halo positions read
    zero padding), so it has no data dependence on the ``ppermute`` results;
    XLA's latency-hiding scheduler can run the collective concurrently.
    Only the O(halo) edge-correction lanes wait on the neighbors.
    """
    m, nloc = x_local.shape
    halo = max((abs(o) for o in offsets), default=0)
    if halo > nloc:
        raise ValueError(
            f"dia_spmm_halo_t: bandwidth {halo} exceeds local rows {nloc}; "
            "use fewer shards or a wider partition"
        )
    if halo == 0:
        return data_local[0][None, :] * x_local

    ndev = lax.axis_size(axis)
    if ndev > 1:  # launch the exchange first; nothing below consumes it yet
        fwd = [(i, i + 1) for i in range(ndev - 1)]
        bwd = [(i + 1, i) for i in range(ndev - 1)]
        from_left = lax.ppermute(x_local[:, -halo:], axis, fwd)
        from_right = lax.ppermute(x_local[:, :halo], axis, bwd)

    # interior sweep on zero-padded local lanes (overlappable with the halos)
    Xp = jnp.pad(x_local, ((0, 0), (halo, halo)))
    acc = jnp.zeros_like(x_local)
    for d, off in enumerate(offsets):
        shifted = lax.slice(Xp, (0, halo + off), (m, halo + off + nloc))
        acc = acc + data_local[d][None, :] * shifted

    if ndev > 1:
        # edge corrections: the first/last |off| lanes of each off-diagonal
        # read neighbor lanes. All slices are static.
        for d, off in enumerate(offsets):
            if off < 0:
                acc = acc.at[:, :-off].add(
                    data_local[d][None, :-off] * from_left[:, halo + off :]
                )
            elif off > 0:
                acc = acc.at[:, nloc - off :].add(
                    data_local[d][None, nloc - off :] * from_right[:, :off]
                )
    return acc


def padded_spmm_halo(
    Ap: PaddedDIA,
    Xp: jax.Array,
    axis: str = ROW_AXIS,
) -> jax.Array:
    """Local rows of ``(A @ X)^T`` with the interior sweep on the guarded
    layout — the ``spmm='padded'`` hot path.

    ``Ap`` is the shard's LOCAL block pre-padded into a per-shard guarded
    ``PaddedLayout`` (logical rows [G, G + nloc)); ``Xp`` is the guarded
    local multivector (mpad, width) with zero guards. The kernel computes
    the full local contribution reading zeros beyond the local block;
    the ppermute halo slabs feed only the O(halo) edge-correction lanes,
    which are the only values waiting on the collective.
    """
    G, nloc = Ap.guard, Ap.n
    offsets = Ap.offsets
    halo = max((abs(o) for o in offsets), default=0)
    if halo > nloc:
        raise ValueError(
            f"padded_spmm_halo: bandwidth {halo} exceeds local rows {nloc}; "
            "use fewer shards or a wider partition"
        )
    mpad = Xp.shape[0]
    ndev = lax.axis_size(axis)
    if ndev > 1 and halo > 0:
        fwd = [(i, i + 1) for i in range(ndev - 1)]
        bwd = [(i + 1, i) for i in range(ndev - 1)]
        from_left = lax.ppermute(
            lax.slice(Xp, (0, G + nloc - halo), (mpad, G + nloc)), axis, fwd
        )
        from_right = lax.ppermute(
            lax.slice(Xp, (0, G), (mpad, G + halo)), axis, bwd
        )
    Y = padded_spmm(Ap, Xp)
    if ndev > 1 and halo > 0:
        for d, off in enumerate(offsets):
            if off < 0:
                Y = Y.at[:, G : G - off].add(
                    Ap.data[d][None, G : G - off] * from_left[:, halo + off :]
                )
            elif off > 0:
                Y = Y.at[:, G + nloc - off : G + nloc].add(
                    Ap.data[d][None, G + nloc - off : G + nloc]
                    * from_right[:, :off]
                )
    return Y


def halo_exchange(x_local: jax.Array, halo: int, axis: str = ROW_AXIS):
    """Column-layout wrapper over ``halo_exchange_t`` (x_local (nloc, m))."""
    return halo_exchange_t(x_local.T, halo, axis).T


def dia_spmm_halo(
    data_local: jax.Array,
    offsets: tuple,
    x_local: jax.Array,
    axis: str = ROW_AXIS,
) -> jax.Array:
    """Column-layout wrapper over ``dia_spmm_halo_t`` (x_local (nloc, m))."""
    return dia_spmm_halo_t(data_local, offsets, x_local.T, axis).T


def psum_reduce(axis: str = ROW_AXIS):
    return lambda g: lax.psum(g, axis)


def local_diag_block(data_local: jax.Array, offsets: tuple) -> jax.Array:
    """Zero the cross-shard couplings of a row-sharded DIA block: entry
    (i_loc, i_loc + off) belongs to the shard's diagonal block iff the
    column is local. Purely local — no global index needed."""
    nloc = data_local.shape[1]
    i = jnp.arange(nloc)
    out = []
    for d, off in enumerate(offsets):
        valid = (i + off >= 0) & (i + off < nloc)
        out.append(jnp.where(valid, data_local[d], 0.0))
    return jnp.stack(out)


class _ShardEngine:
    """Per-shard internal layout + SpMM dispatch for the sharded drivers.

    mode 'padded': a per-shard guarded ``PaddedLayout``; the hot loop
    iterates guarded multivectors and every SpMM is ``padded_spmm_halo``.
    mode 'xla': the plain-layout slice formulation (``dia_spmm_halo_t``). Built INSIDE shard_map from the
    traced local blocks; all geometry is static.
    """

    def __init__(self, datas, offsets_list, m_max: int, axis: str, mode: str):
        if mode not in ("padded", "xla"):
            raise ValueError(f"unknown spmm mode {mode!r} (padded|xla)")
        self.axis = axis
        self.mode = mode
        self.nloc = datas[0].shape[1]
        self.datas = list(datas)
        self.offsets_list = [tuple(o) for o in offsets_list]
        if mode == "padded":
            union = tuple(sorted(set().union(*map(set, self.offsets_list))))
            self.layout = PaddedLayout(self.nloc, m_max, union)
            self.ops = [
                self.layout.pad_operator(
                    DIAMatrix(data=d, offsets=o, shape=(self.nloc, self.nloc))
                )
                for d, o in zip(self.datas, self.offsets_list)
            ]
        else:
            self.layout = None
            self.ops = list(zip(self.datas, self.offsets_list))

    @property
    def a_int(self):
        """Operand handed to the solver cores: derives the internal
        EngineSpec (``_spec_of``) so results unpad correctly; the SpMM
        itself always goes through the hooks."""
        return self.ops[0] if self.mode == "padded" else None

    def apply(self, i: int, dtype=None):
        """Transposed-layout SpMM hook for operand i. ``dtype`` streams the
        operand (and expects multivectors) in that dtype — the bf16
        preconditioner path; the cast is traced outside the solver loop so
        the narrow copy materializes once per solve."""
        if self.mode == "padded":
            op = self.ops[i]
            if dtype is not None:
                op = PaddedDIA(
                    data=op.data.astype(dtype), offsets=op.offsets,
                    shape=op.shape, guard=op.guard,
                )
            return partial(padded_spmm_halo, op, axis=self.axis)
        data = self.datas[i]
        if dtype is not None:
            data = data.astype(dtype)
        return partial(
            dia_spmm_halo_t, data, self.offsets_list[i], axis=self.axis
        )

    def pad_q0(self, q0: jax.Array) -> jax.Array:
        return q0 if self.layout is None else self.layout.pad(q0)

    def inv_diag(self, i: int) -> jax.Array:
        """Guard-safe reciprocal diagonal of operand i (Jacobi)."""
        if self.mode == "padded":
            return 1.0 / self.ops[i].padded_diagonal(fill=1.0)
        return 1.0 / self.datas[i][self.offsets_list[i].index(0)]


def schwarz_inverse_t(
    data_local: jax.Array,
    offsets: tuple,
    apply_a,
    gram_reduce,
    rtol: float = 1e-6,
    maxiter: int = 200,
    C: int = 256,
    layout: Optional[PaddedLayout] = None,
    direct: bool = False,
):
    """Additive-Schwarz (non-overlapping block-Jacobi) inverse for the
    sharded solvers: each shard factorizes ITS diagonal band block with the
    device block-banded engine (factorize/banded.py) and the global CG uses
    the exact local solves as its (fixed, SPD) preconditioner — domain
    decomposition, and the distributed replacement for
    the reference's global direct factorization (umfpacktools.hh:16-220).
    Convergence then depends on the subdomain coupling, not the local
    condition number: measured on the 8-device CPU mesh (2D Laplacian,
    rtol 1e-8), the inner iteration count drops ~2.4x vs plain Jacobi-CG
    (tests/test_dist.py) — and each Schwarz iteration's banded scan is
    local matmul work instead of extra global reduction rounds.

    Built INSIDE shard_map: the factorization itself is jitted device code,
    so it fuses into the same XLA computation as the solve. ``layout``: when
    the solve runs on the guarded internal layout, residuals are unpadded
    for the banded block solve and re-guarded after (the O(1)-copy bridge;
    the CG SpMMs themselves stay on the guarded layout). Returns a
    transposed-layout solve callable (marked ``layout_t``).
    """
    from dune_eigensolver_tpu.factorize.banded import (
        banded_solve,
        factorize_banded_device,
    )
    from dune_eigensolver_tpu.factorize.cg import cg_solve_t

    nloc = data_local.shape[1]
    blk = local_diag_block(data_local, offsets)
    A_blk = DIAMatrix(data=blk, offsets=offsets, shape=(nloc, nloc))
    F = factorize_banded_device(A_blk, C=C)

    if layout is None:

        def precond(R):  # (m, nloc) -> (m, nloc), exact local block solve
            return banded_solve(F, R.T).T

    else:
        G, n_, width = layout.G, layout.n, layout.width

        def precond(R):  # guarded (m, width): unpad -> block solve -> guard
            R_log = lax.slice(R, (0, G), (R.shape[0], G + n_))
            Y = banded_solve(F, R_log.T).T
            return jnp.pad(Y, ((0, 0), (G, width - G - n_)))

    if direct:
        # 1-device mesh: the "local" diagonal block IS the whole operator,
        # so the Schwarz preconditioner is the exact inverse — the CG
        # wrapper would spend >= 2 banded solves per apply verifying what
        # one already delivers. Apply the block solve directly; at P > 1
        # the cross-shard coupling
        # makes the global CG mathematically necessary.
        solve = precond
    else:

        def solve(X):
            Y, _ = cg_solve_t(
                apply_a,
                X,
                rtol=rtol,
                maxiter=maxiter,
                gram_reduce=gram_reduce,
                precond_apply=precond,
            )
            return Y

    solve.layout_t = True
    return solve


def _shard_dia(A: DIAMatrix, mesh: Mesh, axis: str) -> DIAMatrix:
    data = jax.device_put(A.data, NamedSharding(mesh, P(None, axis)))
    return DIAMatrix(data=data, offsets=A.offsets, shape=A.shape)


def _pad_rows_dia(A: DIAMatrix, n_pad: int, diag_fill: float) -> DIAMatrix:
    """Extend an n x n DIA matrix to n_pad x n_pad with DECOUPLED pad rows:
    ``diag_fill`` on the main diagonal, zero everywhere else. Coefficients of
    real rows never reference pad columns (DIA data is zero where the column
    index falls outside the logical matrix), so with a zero start vector the
    pad lanes stay exactly zero through every linear solver operation and
    the spectrum of the original problem is untouched."""
    n = A.shape[0]
    if n_pad == n:
        return A
    data = jnp.pad(A.data, ((0, 0), (0, n_pad - n)))
    if diag_fill != 0.0:
        if 0 not in A.offsets:
            raise ValueError(
                "_pad_rows_dia: operator has no main diagonal to carry the "
                "pad-row identity; cannot pad to the mesh size"
            )
        d0 = A.offsets.index(0)
        i = jnp.arange(n_pad)
        data = data.at[d0].set(
            jnp.where(i >= n, jnp.asarray(diag_fill, data.dtype), data[d0])
        )
    return DIAMatrix(data=data, offsets=A.offsets, shape=(n_pad, n_pad))


def _padded_rows(n: int, mesh: Mesh) -> int:
    ndev = mesh.devices.size
    return -(-n // ndev) * ndev


def _slice_result(res, n: int):
    """Drop the pad rows from the globally-assembled eigenvectors."""
    if res.eigenvectors.shape[0] == n:
        return res
    return dataclasses.replace(res, eigenvectors=res.eigenvectors[:n])


def _random_q0_t(seed, n, n_pad, m, mesh, axis, dtype):
    """Transposed start block sharded over lanes: (m, n_pad) with rows
    split; pad lanes are EXACTLY zero (the decoupled-pad-row invariant)."""
    from dune_eigensolver_tpu.solvers.standard import random_multivector_t

    Q0 = random_multivector_t(jax.random.PRNGKey(seed), n, m, dtype)
    if n_pad != n:
        Q0 = jnp.pad(Q0, ((0, 0), (0, n_pad - n)))
    return jax.device_put(Q0, NamedSharding(mesh, P(None, axis)))


def _pick_spmm(spmm: Optional[str]) -> str:
    """The caller's mode, or ``backend.dia_spmm_mode()``."""
    if spmm is None:
        from dune_eigensolver_tpu import backend

        return backend.dia_spmm_mode()
    return spmm


from collections import OrderedDict

_PROGRAM_CACHE: "OrderedDict" = OrderedDict()
# keys include full float configs (tol/shift/rtol), so a parameter sweep
# would otherwise leak one compiled shard_map program per point (VERDICT r4
# Weak #7); LRU-bound well above any sane working set of live solvers.
_PROGRAM_CACHE_MAX = 64


def _cached_program(key, make):
    """Memoize the jitted shard_map solver programs (bounded LRU).

    Every sharded driver builds its ``local_solver`` as a fresh closure, so
    a plain ``jax.jit`` would miss its cache on EVERY call — a re-trace +
    compile per solve. Same invariant as the inverse factories (CLAUDE.md): programs must be
    keyed on their STATIC configuration, with all array data flowing as
    arguments. ``key`` must include every Python constant the closure bakes
    into the trace (mesh, mode, offsets, solver cfg)."""
    fn = _PROGRAM_CACHE.get(key)
    if fn is None:
        fn = _PROGRAM_CACHE[key] = make()
        while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_MAX:
            _PROGRAM_CACHE.popitem(last=False)
    else:
        _PROGRAM_CACHE.move_to_end(key)
    return fn


def _mesh_key(mesh: Mesh):
    return (
        tuple(d.id for d in mesh.devices.flat),
        tuple(mesh.axis_names),
        tuple(mesh.shape.values()),
    )


def sharded_standard_largest(
    A: DIAMatrix,
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
    spmm: Optional[str] = None,
):
    """Multi-chip standard_largest: same semantics, rows sharded over mesh.

    ``spmm``: 'padded' runs the hot loop on the per-shard guarded layout;
    'xla' is the slice formulation; None asks ``backend.dia_spmm_mode()``.
    """
    from dune_eigensolver_tpu.solvers.standard import (
        _largest_core,
        padded_width,
    )

    mesh = mesh or make_mesh(axis=axis)
    mode = _pick_spmm(spmm)
    n = A.shape[0]
    n_pad = _padded_rows(n, mesh)
    A_sh = A.with_shifted_diagonal(shift) if shift != 0.0 else A
    A_sh = _pad_rows_dia(A_sh, n_pad, 1.0)
    A_sh = _shard_dia(A_sh, mesh, axis)
    m = padded_width(nev, block)
    Q0 = _random_q0_t(seed, n, n_pad, m, mesh, axis, A.dtype)
    reduce_ = psum_reduce(axis)

    def local_solver(adata, q0):
        eng = _ShardEngine([adata], [A.offsets], m, axis, mode)
        cfg = (
            nev,
            float(tol),
            int(maxiter),
            float(shift),
            int(block),
            int(ortho_iterations),
            bool(rayleigh_ritz),
            int(n_pad),
            jnp.dtype(A.dtype),
        )
        hooks = (eng.apply(0), reduce_)
        return _largest_core(eng.a_int, eng.pad_q0(q0), hooks, cfg)

    key = (
        "largest", _mesh_key(mesh), mode, axis, A.offsets, nev, float(tol),
        int(maxiter), float(shift), int(block), int(ortho_iterations),
        bool(rayleigh_ritz), int(n_pad), jnp.dtype(A.dtype).name, m,
    )
    fn = _cached_program(
        key,
        lambda: jax.jit(
            jax.shard_map(
                local_solver,
                mesh=mesh,
                in_specs=(P(None, axis), P(None, axis)),
                out_specs=_result_specs(axis),
                check_vma=False,
            )
        ),
    )
    return _slice_result(fn(A_sh.data, Q0), n)


def sharded_standard_inverse(
    A: DIAMatrix,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    mesh: Optional[Mesh] = None,
    block: int = 8,
    seed: int = 123,
    ortho_iterations: int = 1,
    cg_rtol: float = 1e-6,
    cg_maxiter: int = 2000,
    axis: str = ROW_AXIS,
    inner: str = "schwarz",
    spmm: Optional[str] = None,
):
    """Multi-chip standard_inverse: smallest eigenpairs via shift-invert.

    ``inner``: the distributed inverse engine. 'schwarz' (default) runs the
    global CG preconditioned by exact per-shard banded block solves
    (additive Schwarz — see ``schwarz_inverse_t``); 'cg' is plain
    Jacobi-CG. The single-chip global direct solve cannot shard (its block
    recursion is sequential across shards), but its per-shard restriction
    can — that is exactly the Schwarz preconditioner."""
    from dune_eigensolver_tpu.factorize.cg import cg_solve_t
    from dune_eigensolver_tpu.solvers.standard import padded_width

    mesh = mesh or make_mesh(axis=axis)
    mode = _pick_spmm(spmm)
    n = A.shape[0]
    n_pad = _padded_rows(n, mesh)
    inner = _pick_inner(inner, A, n_pad // mesh.devices.size)
    A_sh = A.with_shifted_diagonal(shift) if shift != 0.0 else A
    A_sh = _pad_rows_dia(A_sh, n_pad, 1.0)
    A_shd = _shard_dia(A_sh, mesh, axis)
    m = padded_width(nev, block)
    Q0 = _random_q0_t(seed, n, n_pad, m, mesh, axis, A.dtype)
    reduce_ = psum_reduce(axis)

    def local_solver(adata, q0):
        eng = _ShardEngine([adata], [A.offsets], m, axis, mode)
        apply_a = eng.apply(0)

        if inner == "schwarz":
            solve = schwarz_inverse_t(
                adata, A.offsets, apply_a, reduce_,
                rtol=cg_rtol, maxiter=cg_maxiter, layout=eng.layout,
                direct=(int(mesh.shape[axis]) == 1),
            )

            def inv_fn(_aux, X):
                return solve(X)

        else:
            inv_diag = eng.inv_diag(0)

            def inv_fn(_aux, X):
                Y, _ = cg_solve_t(
                    apply_a,
                    X,
                    inv_diag=inv_diag,
                    rtol=cg_rtol,
                    maxiter=cg_maxiter,
                    gram_reduce=reduce_,
                )
                return Y

        cfg = (
            nev,
            float(tol),
            int(maxiter),
            float(shift),
            int(block),
            int(ortho_iterations),
            jnp.dtype(A.dtype),
        )
        return _sharded_inverse_core(
            eng.a_int, apply_a, inv_fn, eng.pad_q0(q0), reduce_, cfg
        )

    key = (
        "standard_inverse", _mesh_key(mesh), mode, axis, A.offsets, nev,
        float(tol), int(maxiter), float(shift), int(block),
        int(ortho_iterations), float(cg_rtol), int(cg_maxiter), inner,
        int(n_pad), jnp.dtype(A.dtype).name, m,
    )
    fn = _cached_program(
        key,
        lambda: jax.jit(
            jax.shard_map(
                local_solver,
                mesh=mesh,
                in_specs=(P(None, axis), P(None, axis)),
                out_specs=_result_specs(axis),
                check_vma=False,
            )
        ),
    )
    return _slice_result(fn(A_shd.data, Q0), n)


def _sharded_inverse_core(A_int, apply_a, inv_fn, Q0, gram_reduce, cfg):
    """standard_inverse iteration with a caller-supplied operator
    application for the Rayleigh quotients (row-sharded SpMM needs the halo
    exchange, not a local-slice spmm). Transposed (possibly guarded)
    layout; ``A_int`` only derives the internal spec for unpadding."""
    from functools import partial as _partial

    from dune_eigensolver_tpu.ops.ortho import (
        dot_products_diagonal_t,
        orthonormalize_blocked_t,
    )
    from dune_eigensolver_tpu.solvers.engine import from_internal_vectors
    from dune_eigensolver_tpu.solvers.result import EigenResult, sort_result_t
    from dune_eigensolver_tpu.solvers.standard import _spec_of

    nev, tol, maxiter, shift, block, ortho_iterations, dtype = cfg
    shift_ = jnp.asarray(shift, dtype)
    m = Q0.shape[0]
    spec = _spec_of(A_int)
    ortho = _partial(
        orthonormalize_blocked_t,
        block=block,
        gram_reduce=gram_reduce,
        iterations=ortho_iterations,
    )
    Q = ortho(Q0)

    def body(state):
        Q, s_prev, k, _ = state
        Q2 = ortho(inv_fn(None, Q))
        AQ2 = apply_a(Q2)
        s = gram_reduce(dot_products_diagonal_t(Q2, AQ2)) - shift_
        distance = jnp.max(jnp.abs(s - s_prev))
        return Q2, s, k + 1, distance

    def cond(state):
        _, _, k, distance = state
        return (k < maxiter) & ((k < 2) | (distance >= tol))

    s0 = jnp.zeros((m,), dtype)
    Q, s, k, distance = lax.while_loop(
        cond, body, (Q, s0, jnp.zeros((), jnp.int32), jnp.asarray(jnp.inf, dtype))
    )
    evals, evecs_t = sort_result_t(s, Q, nev, descending=False)
    return EigenResult(
        eigenvalues=evals,
        eigenvectors=from_internal_vectors(evecs_t, spec, Q.shape[1]),
        iterations=k,
        converged=distance < tol,
        criterion=distance,
        ortho_monitor=jnp.zeros((), dtype),
    )


def sharded_generalized_inverse(
    A: DIAMatrix,
    B: DIAMatrix,
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
    spmm: Optional[str] = None,
):
    """Multi-chip generalized_inverse.

    ``inner='schwarz'`` (default): global CG preconditioned by exact
    per-shard banded block solves of the shifted operator (additive
    Schwarz, ``schwarz_inverse_t``) — the distributed stand-in for the
    reference's global direct factorization. ``inner='cg'``: plain
    Jacobi-CG (round-1 behavior). ``spmm='padded'`` runs every SpMM —
    outer AND inner-CG — on the per-shard guarded layout."""
    from dune_eigensolver_tpu.factorize.cg import cg_solve_t
    from dune_eigensolver_tpu.solvers.generalized import _gen_core
    from dune_eigensolver_tpu.solvers.standard import padded_width

    mesh = mesh or make_mesh(axis=axis)
    mode = _pick_spmm(spmm)
    n = A.shape[0]
    n_pad = _padded_rows(n, mesh)
    inner = _pick_inner(inner, A, n_pad // mesh.devices.size)

    A_op = A
    if shift != 0.0:
        A_op = A_op.axpy(shift, B)
    if reg != 0.0:
        A_op = A_op.with_shifted_diagonal(reg)
    A_op = _pad_rows_dia(A_op, n_pad, 1.0)
    B_p = _pad_rows_dia(B, n_pad, 0.0)
    A_op = _shard_dia(A_op, mesh, axis)
    B_sh = _shard_dia(B_p, mesh, axis)
    m = padded_width(nev, block)
    Q0 = _random_q0_t(seed, n, n_pad, m, mesh, axis, A.dtype)

    reduce_ = psum_reduce(axis)

    def local_solver(adata, bdata, q0):
        eng = _ShardEngine(
            [adata, bdata], [A.offsets, B.offsets], m, axis, mode
        )
        apply_a = eng.apply(0)
        apply_b = eng.apply(1)

        if inner == "schwarz":
            solve = schwarz_inverse_t(
                adata, A.offsets, apply_a, reduce_,
                rtol=cg_rtol, maxiter=cg_maxiter, layout=eng.layout,
                direct=(int(mesh.shape[axis]) == 1),
            )

            def inv_fn(_aux, X):
                return solve(X)

        else:
            inv_diag = eng.inv_diag(0)

            def inv_fn(_aux, X):
                Y, _ = cg_solve_t(
                    apply_a,
                    X,
                    inv_diag=inv_diag,
                    rtol=cg_rtol,
                    maxiter=cg_maxiter,
                    gram_reduce=reduce_,
                )
                return Y

        cfg = (
            nev,
            float(tol),
            int(maxiter),
            float(shift),  # eval shift: shift/reg pre-folded into adata
            int(block),
            int(min_iter),
            int(ortho_iterations),
            bool(rayleigh_ritz),
            int(n_pad),
            jnp.dtype(A.dtype),
        )
        hooks = (apply_a, apply_b, reduce_, inv_fn)
        B_int = eng.ops[1] if mode == "padded" else None
        return _gen_core(eng.a_int, B_int, None, eng.pad_q0(q0), hooks, cfg)

    key = (
        "generalized_inverse", _mesh_key(mesh), mode, axis, A.offsets,
        B.offsets, nev, float(tol), int(maxiter), float(shift), float(reg),
        int(block), int(min_iter), int(ortho_iterations),
        bool(rayleigh_ritz), float(cg_rtol), int(cg_maxiter), inner,
        int(n_pad), jnp.dtype(A.dtype).name, m,
    )
    fn = _cached_program(
        key,
        lambda: jax.jit(
            jax.shard_map(
                local_solver,
                mesh=mesh,
                in_specs=(P(None, axis), P(None, axis), P(None, axis)),
                out_specs=_result_specs(axis),
                check_vma=False,
            )
        ),
    )
    return _slice_result(fn(A_op.data, B_sh.data, Q0), n)


def sharded_lobpcg_generalized(
    A: DIAMatrix,
    B: DIAMatrix,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    reg: float = 0.0,
    mesh: Optional[Mesh] = None,
    block: int = 8,
    seed: int = 123,
    min_iter: int = 3,
    ortho_eps: float = 1e-9,
    cg_rtol: float = 1e-2,
    cg_maxiter: int = 100,
    axis: str = ROW_AXIS,
    spmm: Optional[str] = None,
    prec_dtype=None,
    precond: str = "cg",
    ortho_block=None,
):
    """Multi-chip LOBPCG on the reciprocal pencil (solvers/lobpcg.py).

    ``precond='cg'`` (default, any operand): a *loose* matrix-free CG on the
    shifted operator (rtol defaults to 1e-2 — LOBPCG only needs an
    approximate inverse, so the inner Krylov runs an order of magnitude
    shorter than the sharded shift-invert solvers' inner solve).
    ``precond='mg'`` (structured 2D/3D stencils): the distributed geometric
    V(1,1) cycle (dist/mg.py) — partitioned fine smoothing through the halo
    SpMM, shard-local semi-coarsening, ONE all_gather per cycle, replicated
    coarse levels; the multi-card version of the single-card north-star
    recipe (BASELINE.md). All Gram reductions psum over the row axis; SpMMs
    halo-exchange between neighbouring shards.

    ``prec_dtype``: stream the preconditioner (inner CG, or MG fine-level
    smoothing) in this dtype (casting at the preconditioner boundary; dots
    still accumulate f32 before the psum). ``jnp.bfloat16`` halves both the
    per-shard memory traffic and the halo bytes — the single-card
    north-star recipe, shard-local here.

    ``ortho_block``: forwarded to the LOBPCG core (solvers/lobpcg.py) — 24
    with an MG preconditioner mirrors the single-chip north-star setting.
    """
    from dune_eigensolver_tpu.factorize.cg import cg_solve_t
    from dune_eigensolver_tpu.solvers.lobpcg import _lobpcg_core
    from dune_eigensolver_tpu.solvers.standard import padded_width

    mesh = mesh or make_mesh(axis=axis)
    mode = _pick_spmm(spmm)
    n = A.shape[0]
    n_pad = _padded_rows(n, mesh)
    if precond not in ("cg", "mg"):
        raise ValueError(f"unknown precond {precond!r} (cg|mg)")
    n_shards = int(mesh.shape[axis])
    mg_dims = None
    if precond == "mg":
        from dune_eigensolver_tpu.dist.mg import sharded_mg_geometry

        # validate OUTSIDE shard_map so misuse raises, not traces
        mg_dims = sharded_mg_geometry(A.offsets, n, n_pad, n_shards)

    A_op = A
    if shift != 0.0:
        A_op = A_op.axpy(shift, B)
    if reg != 0.0:
        A_op = A_op.with_shifted_diagonal(reg)
    A_op = _pad_rows_dia(A_op, n_pad, 1.0)
    B_p = _pad_rows_dia(B, n_pad, 0.0)
    A_op = _shard_dia(A_op, mesh, axis)
    B_sh = _shard_dia(B_p, mesh, axis)
    m = padded_width(nev, block)
    Q0 = _random_q0_t(seed, n, n_pad, m, mesh, axis, A.dtype)
    reduce_ = psum_reduce(axis)

    def local_solver(adata, bdata, q0):
        # the LOBPCG search block is (3m, n*)
        eng = _ShardEngine(
            [adata, bdata], [A.offsets, B.offsets], 3 * m, axis, mode
        )
        apply_a = eng.apply(0)
        apply_b = eng.apply(1)
        inv_diag = eng.inv_diag(0)

        if precond == "mg":
            from dune_eigensolver_tpu.dist.mg import make_sharded_mg_prec_fn

            prec_fn = make_sharded_mg_prec_fn(
                eng, mg_dims, n_shards, axis, dtype=prec_dtype
            )
        else:
            apply_a_p = eng.apply(0, dtype=prec_dtype)
            inv_diag_p = (
                inv_diag if prec_dtype is None else inv_diag.astype(prec_dtype)
            )

            def prec_fn(_aux, X):
                Xp_ = X if prec_dtype is None else X.astype(prec_dtype)
                Y, _ = cg_solve_t(
                    apply_a_p,
                    Xp_,
                    inv_diag=inv_diag_p,
                    rtol=cg_rtol,
                    maxiter=cg_maxiter,
                    gram_reduce=reduce_,
                )
                return Y.astype(X.dtype)

        cfg = (
            nev,
            float(tol),
            int(maxiter),
            float(shift),  # eval shift: shift/reg pre-folded into adata
            int(block),
            int(min_iter),
            float(ortho_eps),
            int(n_pad),
            jnp.dtype(A.dtype),
            2,  # ortho_iterations: CholeskyQR2
            ortho_block,  # None = b-blocked sweep (robust); 24 = north star
        )
        hooks = (apply_a, apply_b, reduce_, prec_fn)
        B_int = eng.ops[1] if mode == "padded" else None
        return _lobpcg_core(eng.a_int, B_int, None, eng.pad_q0(q0), hooks, cfg)

    key = (
        "lobpcg", _mesh_key(mesh), mode, axis, A.offsets, B.offsets, nev,
        float(tol), int(maxiter), float(shift), float(reg), int(block),
        int(min_iter), float(ortho_eps), float(cg_rtol), int(cg_maxiter),
        precond, mg_dims, ortho_block,
        None if prec_dtype is None else jnp.dtype(prec_dtype).name,
        int(n_pad), jnp.dtype(A.dtype).name, m,
    )
    fn = _cached_program(
        key,
        lambda: jax.jit(
            jax.shard_map(
                local_solver,
                mesh=mesh,
                in_specs=(P(None, axis), P(None, axis), P(None, axis)),
                out_specs=_result_specs(axis),
                check_vma=False,
            )
        ),
    )
    return _slice_result(fn(A_op.data, B_sh.data, Q0), n)


def _pick_inner(inner: str, A, nloc: int) -> str:
    """Validate/auto-downgrade the distributed inverse engine: the Schwarz
    block factorization needs the band inside the shard and inside the
    device engine's block-size ceiling."""
    from dune_eigensolver_tpu.factorize.banded import _DEVICE_BW_MAX

    if inner not in ("schwarz", "cg"):
        raise ValueError(f"unknown inner engine {inner!r} (schwarz|cg)")
    if inner == "schwarz":
        bw = max((abs(o) for o in A.offsets), default=0)
        if bw > min(nloc, _DEVICE_BW_MAX):
            from dune_eigensolver_tpu.utils.vlog import warn_fallback

            warn_fallback(
                f"schwarz inner engine needs bandwidth {bw} <= "
                f"min(nloc={nloc}, {_DEVICE_BW_MAX}) -> downgrading to "
                "plain Jacobi-CG (no per-shard block solves; expect more "
                "inner iterations)"
            )
            return "cg"
    return inner


def _result_specs(axis: str):
    from dune_eigensolver_tpu.solvers.result import EigenResult

    return EigenResult(
        eigenvalues=P(),
        eigenvectors=P(axis, None),
        iterations=P(),
        converged=P(),
        criterion=P(),
        ortho_monitor=P(),
    )
