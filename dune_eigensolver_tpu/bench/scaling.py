"""Weak-scaling measurement over the device mesh.

BASELINE.md's north star asks for 1 -> N weak-scaling efficiency >= 80% on
the row-partitioned solver. This harness keeps the per-device row count
fixed, grows the mesh, and measures the halo-exchange SpMM iteration (the
communication-bound hot loop): efficiency(P) = t(1) / t(P) — ideal weak
scaling keeps per-iteration time flat since local work is constant and the
halo volume is O(bw * m) per neighbor, independent of P.

On a CPU-simulated mesh (tests) the numbers characterize the simulation,
not the interconnect; the same protocol runs unchanged on a mesh of GPUs
(four cards of one host, joined all to all by NVLink).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dune_eigensolver_tpu.dist.mesh import ROW_AXIS, make_mesh
from dune_eigensolver_tpu.dist.sharded import _shard_dia
from dune_eigensolver_tpu.sparse import problems


from dune_eigensolver_tpu.dist.sharded import _pick_spmm

# per-iteration times below this are timer noise, not a measurement; an
# efficiency ratio against them is garbage. Such rows report efficiency =
# nan and must be excluded from any scaling claim.
_EFF_FLOOR = 1e-7


def _efficiency(t1: Optional[float], t: float) -> float:
    if t1 is None or t1 <= _EFF_FLOOR or t <= _EFF_FLOOR:
        return float("nan")
    return t1 / t


def _chain_time(make_chain, args, K: int, reps: int = 3) -> float:
    """Per-iteration time of a K-chained program, timed as bench/timing.py
    does: one warm-up call, then the best of ``reps`` runs ended by
    ``block_until_ready``, divided by K."""
    f = make_chain(K)
    jax.block_until_ready(f(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        best = min(best, time.perf_counter() - t0)
    return best / K


def weak_scaling_spmm(
    rows_per_device: int = 1 << 14,
    m: int = 8,
    n_iter: int = 50,
    device_counts: Optional[List[int]] = None,
    dtype=np.float32,
    verbose: int = 0,
    coupling: str = "islands",
    spmm: Optional[str] = None,
) -> List[dict]:
    """Measure the sharded SpMM per-iteration time at fixed rows/device.

    rows_per_device must be a square (an N x N grid strip per device).
    Returns one record per mesh size with ``efficiency`` relative to P=1.

    ``coupling``: 'islands' = p decoupled N x N Laplacians (the matrix the
    reference's disabled matvec benchmark wanted, cc:421-425; exchanged
    halo rows multiply zeros) or 'connected' = one N x (N*p) rectangular
    Laplacian whose shard cuts carry REAL -1 couplings — halo data is live
    and any correctness/overlap regression shows up in the numbers.

    ``spmm``: the engine mode the SOLVERS run — 'padded' (per-shard guarded
    layout with the DIA kernel) or 'xla' (the slice formulation); None asks
    ``backend.dia_spmm_mode()``, so the sweep measures the path the solvers
    dispatch.
    """
    from dune_eigensolver_tpu.dist.sharded import _ShardEngine

    mode = _pick_spmm(spmm)
    ndev_avail = len(jax.devices())
    counts = device_counts or [p for p in (1, 2, 4, 8) if p <= ndev_avail]
    Nloc = int(np.sqrt(rows_per_device))
    if Nloc * Nloc != rows_per_device:
        raise ValueError("rows_per_device must be a perfect square")

    records = []
    t1 = None
    for p in counts:
        n = rows_per_device * p
        if coupling == "connected":
            Ap = problems.laplacian_dirichlet_rect(Nloc, Nloc * p, dtype=dtype)
        else:
            Ap = problems.laplacian_islands_2d(Nloc, p, dtype=dtype)
        # pre-scale so chained applications stay bounded
        Ap = type(Ap)(data=Ap.data / 8.0, offsets=Ap.offsets, shape=Ap.shape)
        mesh = make_mesh(p)
        A_sh = _shard_dia(Ap, mesh, ROW_AXIS)
        Xt = jax.device_put(
            jnp.ones((m, n), dtype), NamedSharding(mesh, P(None, ROW_AXIS))
        )

        def make_chain(k):
            def many(adata, x):
                eng = _ShardEngine([adata], [Ap.offsets], m, ROW_AXIS, mode)
                apply_a = eng.apply(0)
                return jax.lax.fori_loop(
                    0, k, lambda _, v: apply_a(v), eng.pad_q0(x)
                )

            return jax.jit(
                jax.shard_map(
                    many,
                    mesh=mesh,
                    in_specs=(P(None, ROW_AXIS), P(None, ROW_AXIS)),
                    out_specs=P(None, ROW_AXIS),
                    check_vma=False,
                )
            )

        best = _chain_time(make_chain, (A_sh.data, Xt), n_iter)
        if t1 is None:
            t1 = best
        eff = _efficiency(t1, best)
        rec = dict(
            devices=p,
            rows=n,
            t_iter=best,
            efficiency=eff,
            mode=mode,
            gbps_per_device=(len(Ap.offsets) * n + 2 * n * m)
            * np.dtype(dtype).itemsize
            / best
            / 1e9
            / p,
        )
        records.append(rec)
        if verbose > 0:
            print(
                f"  P={p} n={n} [{mode}] t={best*1e6:.0f}us/iter "
                f"eff={eff:.2f} {rec['gbps_per_device']:.1f} GB/s/dev"
            )
    return records


def weak_scaling_solver(
    rows_per_device: int = 1 << 12,
    m: int = 8,
    n_iter: int = 5,
    device_counts: Optional[List[int]] = None,
    dtype=np.float32,
    verbose: int = 0,
    coupling: str = "connected",
    inner: str = "schwarz",
    inner_iters: int = 10,
    spmm: Optional[str] = None,
    phases: bool = False,
) -> List[dict]:
    """Weak-scale ONE FULL generalized-inverse solver iteration.

    The SpMM-only sweep (``weak_scaling_spmm``) under-informs: the real
    communication load of the sharded solvers is the inner-Krylov psum
    reductions and the blocked B-orthonormalization Gram psums, which
    dominate the per-iteration collective count (VERDICT r2 Weak #3). This
    protocol times the exact ``_gen_core`` body — B-SpMM, inner inverse
    (Schwarz block-solve-preconditioned CG or Jacobi-CG, FIXED iteration
    count so the communication volume is identical at every P), blocked
    B-orthonormalization, Rayleigh quotients — per mesh size at fixed
    rows/device.

    ``coupling``: 'islands' (shard cuts multiply zeros) or 'connected'
    (live -1 couplings across every cut). B is the identity-on-pattern mass
    so the B-SpMM moves representative traffic on any grid shape.

    ``phases=True`` additionally times each phase in isolation (its own
    fori_loop program over the same state) and records ``t_spmm``,
    ``t_inner``, ``t_ortho``, ``t_rayleigh`` — the attribution VERDICT r3
    Weak #5 asked for, so a scaling regression points at ortho-psum vs
    inner-CG vs SpMM instead of a single opaque per-iteration number.
    """
    from functools import partial

    from dune_eigensolver_tpu.dist.sharded import (
        _ShardEngine,
        psum_reduce,
        schwarz_inverse_t,
    )
    from dune_eigensolver_tpu.factorize.cg import cg_solve_t
    from dune_eigensolver_tpu.ops.ortho import (
        b_orthonormalize_blocked_t,
        dot_products_diagonal_t,
    )

    ndev_avail = len(jax.devices())
    counts = device_counts or [p for p in (1, 2, 4, 8) if p <= ndev_avail]
    Nloc = int(np.sqrt(rows_per_device))
    if Nloc * Nloc != rows_per_device:
        raise ValueError("rows_per_device must be a perfect square")

    records = []
    t1 = None
    for p in counts:
        n = rows_per_device * p
        if coupling == "connected":
            Ap = problems.laplacian_dirichlet_rect(Nloc, Nloc * p, dtype=dtype)
        else:
            Ap = problems.laplacian_islands_2d(Nloc, p, dtype=dtype)
        Ap = Ap.with_shifted_diagonal(1e-3)
        Bp = problems.identity_on_pattern(Ap, dtype=dtype)
        mesh = make_mesh(p)
        axis = ROW_AXIS
        A_sh = _shard_dia(Ap, mesh, axis)
        B_sh = _shard_dia(Bp, mesh, axis)
        Xt = jax.device_put(
            jnp.ones((m, n), dtype) / np.sqrt(n),
            NamedSharding(mesh, P(None, axis)),
        )
        reduce_ = psum_reduce(axis)

        mode = _pick_spmm(spmm)

        def make_many(phase, k):
            def many(adata, bdata, x0):
                eng = _ShardEngine(
                    [adata, bdata], [Ap.offsets, Bp.offsets], m, axis, mode
                )
                apply_a = eng.apply(0)
                apply_b = eng.apply(1)
                if inner == "schwarz":
                    solve = schwarz_inverse_t(
                        adata, Ap.offsets, apply_a, reduce_,
                        rtol=1e-30, maxiter=inner_iters, layout=eng.layout,
                    )
                else:
                    inv_diag = eng.inv_diag(0)

                    def solve(X):
                        Y, _ = cg_solve_t(
                            apply_a, X, inv_diag=inv_diag, rtol=1e-30,
                            maxiter=inner_iters, gram_reduce=reduce_,
                        )
                        return Y

                b_ortho = partial(
                    b_orthonormalize_blocked_t, apply_b, block=8,
                    gram_reduce=reduce_,
                )

                def body_full(_, Q):
                    # the exact _gen_core loop body (solvers/generalized.py)
                    Q2 = apply_b(Q)
                    Q1 = solve(Q2)
                    Q1, _norm = b_ortho(Q1)
                    AQ1 = apply_a(Q1)
                    _ra = reduce_(dot_products_diagonal_t(Q1, AQ1))
                    return Q1

                # phase bodies: ONE phase of the loop, state-shape-preserving
                # so each runs under the same fori_loop protocol
                bodies = dict(
                    full=body_full,
                    spmm=lambda _, Q: apply_b(Q),
                    inner=lambda _, Q: solve(Q),
                    ortho=lambda _, Q: b_ortho(Q)[0],
                    rayleigh=lambda _, Q: Q
                    + reduce_(dot_products_diagonal_t(Q, apply_a(Q)))[:, None]
                    * 0.0,
                )
                return jax.lax.fori_loop(
                    0, k, bodies[phase], eng.pad_q0(x0)
                )

            return many

        def timed(phase):
            def make_chain(k):
                return jax.jit(
                    jax.shard_map(
                        make_many(phase, k),
                        mesh=mesh,
                        in_specs=(P(None, axis), P(None, axis), P(None, axis)),
                        out_specs=P(None, axis),
                        check_vma=False,
                    )
                )

            return _chain_time(
                make_chain, (A_sh.data, B_sh.data, Xt), n_iter
            )

        best = timed("full")
        if t1 is None:
            t1 = best
        eff = _efficiency(t1, best)
        rec = dict(
            devices=p, rows=n, t_iter=best, efficiency=eff, inner=inner,
            mode=mode,
        )
        if phases:
            for ph in ("spmm", "inner", "ortho", "rayleigh"):
                rec[f"t_{ph}"] = timed(ph)
        records.append(rec)
        if verbose > 0:
            extra = (
                " ".join(
                    f"{ph}={rec[f't_{ph}']*1e6:.0f}us"
                    for ph in ("spmm", "inner", "ortho", "rayleigh")
                )
                if phases
                else ""
            )
            print(
                f"  P={p} n={n} [{mode}] t={best*1e6:.0f}us/solver-iter "
                f"eff={eff:.2f} {extra}"
            )
    return records


def scaling_test(ptree) -> List[dict]:
    """CLI protocol: greppable
    ``SCALING <kind> <mode> <coupling> P n t_us eff [phase columns]``
    lines — the bare SpMM sweep and the full solver-iteration sweep, each
    per coupling variant (islands + connected). Both sweeps run the mode
    the solvers dispatch (``scaling.spmm``, default ``backend.dia_spmm_mode``);
    solver rows carry a per-phase breakdown (spmm/inner/ortho/rayleigh)."""
    rows = 1 << int(ptree.get("scaling.log2_rows_per_device", 12))
    m = int(ptree["mv.m"])
    spmm_mode = str(ptree.get("scaling.spmm", "")) or None
    out = []
    for coupling in ("islands", "connected"):
        recs = weak_scaling_spmm(
            rows_per_device=rows,
            m=m,
            n_iter=int(ptree.get("scaling.n_iter", 30)),
            dtype=np.dtype(ptree["ev.dtype"]),
            verbose=int(ptree["ev.verbose"]),
            coupling=coupling,
            spmm=spmm_mode,
        )
        for r in recs:
            r["coupling"] = coupling
            r["kind"] = "spmm"
            print(
                f"SCALING spmm {r['mode']} {coupling} {r['devices']} "
                f"{r['rows']} {r['t_iter']*1e6:.0f} {r['efficiency']:.3f}",
                flush=True,
            )
        out.extend(recs)
    for coupling in ("islands", "connected"):
        recs = weak_scaling_solver(
            rows_per_device=rows,
            m=m,
            n_iter=int(ptree.get("scaling.solver_n_iter", 3)),
            dtype=np.dtype(ptree["ev.dtype"]),
            verbose=int(ptree["ev.verbose"]),
            coupling=coupling,
            inner=str(ptree.get("scaling.inner", "schwarz")),
            spmm=spmm_mode,
            phases=bool(int(ptree.get("scaling.phases", 1))),
        )
        for r in recs:
            r["coupling"] = coupling
            r["kind"] = "solver"
            ph_cols = "".join(
                f" {r[f't_{ph}']*1e6:.0f}"
                for ph in ("spmm", "inner", "ortho", "rayleigh")
                if f"t_{ph}" in r
            )
            print(
                f"SCALING solver {r['mode']} {coupling} {r['devices']} "
                f"{r['rows']} {r['t_iter']*1e6:.0f} "
                f"{r['efficiency']:.3f}{ph_cols}",
                flush=True,
            )
        out.extend(recs)
    return out
