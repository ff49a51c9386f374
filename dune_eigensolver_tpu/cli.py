"""Driver CLI: convergence-protocol tests and kernel benchmarks.

Counterpart of the reference driver executable
(src/dune-eigensolver.cc): the same test protocols, problem generators,
greppable result lines, and INI + ``key=value`` configuration
(ParameterTree, config.py). Tests:

* ``largest``  — largest-eigenvalue convergence protocol (cc:620-730, the
  test the reference ``main()`` runs at :777): oracle at 1e-14, oracle at
  tol, ``standard_largest`` at tol, analytic 2D spectrum; result line
  ``N_M_TOL_ESARERROR_ESANERROR_ARANERROR_TIMERATIO_ORACLEITER``.
* ``smallest`` — smallest-eigenvalue convergence protocol (cc:528-617) on
  the GenEO pair (Neumann A, partition-of-unity B) with
  ``generalized_inverse``; line ``N_M_TOL_RASERROR_ARPERROR_TIMERATIO``.
* ``eigenvalues`` — timing run dispatching on ``ev.method`` (cc:448-525):
  'raes' -> generalized_inverse, 'arpack' -> scipy oracle, 'lobpcg' ->
  preconditioned LOBPCG (new capability), 'dist' -> sharded multi-chip
  solve (new capability).
* ``mgs``     — orthonormalization benchmark (cc:164-311) with the roofline
  models of bench/models.py; line ``P_n_m_i_perfn_perfb_intensity``.
* ``matvec``  — SpMM benchmark (cc:315-427); lines
  ``RESULT <variant> <n> <nnz> <m> <GFLOPs> <GBs>``.

Usage: ``python -m dune_eigensolver_tpu [ini-file] [sec.key=value ...]
[--test largest|smallest|eigenvalues|mgs|matvec|all]``
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from dune_eigensolver_tpu.config import ParameterTree


def _log(ptree, level, *msg):
    if int(ptree["ev.verbose"]) >= level:
        print(*msg, flush=True)


def _dtype(ptree):
    return np.dtype(ptree["ev.dtype"])


def _problem_pair(ptree):
    """(A, B) for the generalized protocol: Neumann Laplacian + GenEO B
    (reference cc:475-479). ``ev.problem=elasticity`` swaps in the
    clamped-plate 2D elasticity pencil (BSR 2x2) so every protocol —
    including the tight-accuracy REFINED mode — runs on the reference's
    native general-sparsity operand class."""
    from dune_eigensolver_tpu.sparse import problems

    N = int(ptree["ev.N"])
    overlap = int(ptree["ev.overlap"])
    dt = _dtype(ptree)
    if str(ptree.get("ev.problem", "geneo")) == "elasticity":
        return problems.elasticity_2d(N, dtype=dt)
    if int(ptree["ev.dim"]) == 3:
        A = problems.laplacian_dirichlet_3d(N, dtype=dt)
        from dune_eigensolver_tpu.sparse.formats import DIAMatrix

        B = problems.identity_on_pattern(A, dtype=dt)
        return A, B
    A = problems.laplacian_neumann_2d(N, dtype=dt)
    B = problems.laplacian_b_2d(N, overlap, dtype=dt)
    return A, B


def _inverse_factory(ptree):
    kind = str(ptree["ev.inverse"])
    if kind in ("auto", "banded", "lu"):
        return None  # solver default picks banded for DIA / host-LU otherwise
    if kind == "cg":
        from dune_eigensolver_tpu.factorize import cg_inverse_factory

        return cg_inverse_factory(rtol=1e-4, maxiter=1000)
    if kind == "cg16":
        # bf16-streamed loose CG: preconditioner-grade only (~2 digits) but
        # half the memory traffic — the ev.method=lobpcg north-star recipe.
        # NOT valid for the shift-invert solvers' inner solve.
        import jax.numpy as jnp

        from dune_eigensolver_tpu.factorize import cg_inverse_factory

        return cg_inverse_factory(rtol=1e-2, maxiter=25, dtype=jnp.bfloat16)
    if kind == "chebcg":
        from dune_eigensolver_tpu.factorize import cheb_cg_inverse_factory

        return cheb_cg_inverse_factory(rtol=1e-4, maxiter=300)
    if kind == "mg":
        # geometric V-cycle as an approximate inverse: preconditioner-grade
        # (ev.method=lobpcg); structured 2D/3D stencil operands only
        from dune_eigensolver_tpu.factorize import mg_inverse_factory

        return mg_inverse_factory()
    if kind == "mgcg":
        # V-cycle-preconditioned CG to tolerance: the converging inner
        # solve for shift-invert on structured (3D) stencils
        from dune_eigensolver_tpu.factorize import mg_cg_inverse_factory

        return mg_cg_inverse_factory(rtol=1e-4, maxiter=100)
    if kind == "cheb":
        from dune_eigensolver_tpu.factorize import chebyshev_inverse_factory

        return chebyshev_inverse_factory()
    raise ValueError(f"unknown ev.inverse={kind!r}")


def _want_refine(ptree) -> bool:
    """ev.refine=on runs the compensated Rayleigh-Ritz refinement
    (solvers/refine.py) after the solve; 'auto' (the default) and 'off'
    do not."""
    mode = str(ptree.get("ev.refine", "auto")).lower()
    if mode in ("on", "1", "true"):
        return True
    if mode in ("off", "0", "false", "auto"):
        return False
    raise ValueError(f"unknown ev.refine={mode!r} (on|off|auto)")


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Convergence protocols
# ---------------------------------------------------------------------------


def largest_eigenvalues_convergence_test(ptree) -> dict:
    """Reference cc:620-730. Three-way comparison on the Dirichlet Laplacian:
    scipy oracle @1e-14 (ground truth), oracle @tol, standard_largest @tol,
    plus the closed-form spectrum."""
    from dune_eigensolver_tpu.oracle.analytic import (
        eigenvalues_laplace_dirichlet_2d,
    )
    from dune_eigensolver_tpu.oracle.scipy_oracle import largest_standard
    from dune_eigensolver_tpu.solvers import standard_largest
    from dune_eigensolver_tpu.sparse import problems

    N = int(ptree["ev.N"])
    nev = int(ptree["ev.m"])
    tol = float(ptree["ev.tol"])
    maxiter = int(ptree["ev.maxiter"])
    seed = int(ptree["ev.seed"])
    dt = _dtype(ptree)

    A = problems.laplacian_dirichlet_2d(N, dtype=dt)
    m = -(-nev // int(ptree["ev.block"])) * int(ptree["ev.block"])

    t0 = time.perf_counter()
    ev_oracle, _ = largest_standard(A, m, tol=1e-14)
    t_oracle_hi = time.perf_counter() - t0
    t0 = time.perf_counter()
    largest_standard(A, m, tol=tol)
    t_oracle = time.perf_counter() - t0

    res, t_es = _timed(
        lambda: standard_largest(
            A,
            nev=m,
            tol=tol,
            maxiter=maxiter,
            seed=seed,
            block=int(ptree["ev.block"]),
            rayleigh_ritz=bool(ptree.get("ev.rr", False)),
        )
    )
    ev_es = np.asarray(res.eigenvalues, dtype=np.float64)

    ev_anal = eigenvalues_laplace_dirichlet_2d(N)[::-1][:m]  # descending

    err_es_or = np.abs(ev_es - ev_oracle).max()
    err_es_an = np.abs(ev_es - ev_anal).max()
    err_or_an = np.abs(ev_oracle - ev_anal).max()
    _log(ptree, 1, f"  eigensolver: {ev_es[:4]}")
    _log(ptree, 1, f"  oracle     : {ev_oracle[:4]}")
    _log(ptree, 1, f"  analytic   : {ev_anal[:4]}")
    # greppable line mirroring N_M_TOL_... (reference cc:718-727)
    print(
        f"N_M_TOL_ESARERROR_ESANERROR_ARANERROR_TIMERATIO: "
        f"{N} {m} {tol:.1e} {err_es_or:.3e} {err_es_an:.3e} {err_or_an:.3e} "
        f"{t_es / max(t_oracle, 1e-12):.2f}",
        flush=True,
    )
    err_refined = None
    if _want_refine(ptree):
        from dune_eigensolver_tpu.solvers import refine_eigenpairs

        # refine on the whole block, report the requested nev: the block's
        # trailing vectors act as guard vectors for the leading Ritz values
        w, _ = refine_eigenpairs(A, None, res.eigenvectors)
        err_refined = float(
            np.abs(np.sort(w)[::-1][:nev] - ev_oracle[:nev]).max()
        )
        print(
            f"REFINED_N_M_ERROR: {N} {nev} {err_refined:.3e}",
            flush=True,
        )
    return dict(
        err_vs_oracle=float(err_es_or),
        err_vs_analytic=float(err_es_an),
        oracle_vs_analytic=float(err_or_an),
        err_refined=err_refined,
        time=t_es,
        time_oracle=t_oracle,
        time_oracle_hi=t_oracle_hi,
        iterations=int(res.iterations),
        dtype=str(res.eigenvalues.dtype),
    )


def smallest_eigenvalues_convergence_test(ptree) -> dict:
    """Reference cc:528-617: generalized protocol on the GenEO pair."""
    from dune_eigensolver_tpu.oracle.scipy_oracle import smallest_generalized
    from dune_eigensolver_tpu.solvers import generalized_inverse

    nev = int(ptree["ev.m"])
    tol = float(ptree["ev.tol"])
    shift = float(ptree["ev.shift"])
    reg = float(ptree["ev.regularization"])
    maxiter = int(ptree["ev.maxiter"])
    block = int(ptree["ev.block"])
    m = -(-nev // block) * block
    A, B = _problem_pair(ptree)

    t0 = time.perf_counter()
    ev_truth, _ = smallest_generalized(A, B, m, sigma=-shift, tol=1e-14)
    t_truth = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev_oracle, _ = smallest_generalized(A, B, m, sigma=-shift, tol=tol)
    t_oracle = time.perf_counter() - t0

    res, t_ras = _timed(
        lambda: generalized_inverse(
            A,
            B,
            nev=m,
            tol=tol,
            maxiter=maxiter,
            shift=shift,
            reg=reg,
            block=block,
            seed=int(ptree["ev.seed"]),
            inverse=_inverse_factory(ptree),
            rayleigh_ritz=bool(ptree.get("ev.rr", False)),
        )
    )
    ev_ras = np.asarray(res.eigenvalues, dtype=np.float64)

    err_ras = np.abs(ev_ras - ev_truth).max()
    err_arp = np.abs(ev_oracle - ev_truth).max()
    _log(ptree, 1, f"  eigensolver: {ev_ras[:4]}")
    _log(ptree, 1, f"  oracle     : {ev_truth[:4]}")
    # reference line N_M_TOL_RASERROR_ARPERROR_TIMERATIO_ARPACKITER (cc:606)
    print(
        f"N_M_TOL_RASERROR_ARPERROR_TIMERATIO: "
        f"{ptree['ev.N']} {m} {tol:.1e} {err_ras:.3e} {err_arp:.3e} "
        f"{t_ras / max(t_oracle, 1e-12):.2f}",
        flush=True,
    )
    err_refined = None
    if _want_refine(ptree):
        from dune_eigensolver_tpu.solvers import refine_eigenpairs

        w, _ = refine_eigenpairs(A, B, res.eigenvectors)
        err_refined = float(
            np.abs(np.sort(w)[:nev] - np.sort(ev_truth)[:nev]).max()
        )
        print(
            f"REFINED_N_M_ERROR: {ptree['ev.N']} {nev} {err_refined:.3e}",
            flush=True,
        )
    return dict(
        err_vs_truth=float(err_ras),
        oracle_err=float(err_arp),
        err_refined=err_refined,
        time=t_ras,
        time_oracle=t_oracle,
        time_truth=t_truth,
        iterations=int(res.iterations),
        converged=bool(res.converged),
        dtype=str(res.eigenvalues.dtype),
    )


def eigenvalues_test(ptree) -> dict:
    """Reference cc:448-525: timing run dispatching on ev.method."""
    method = str(ptree["ev.method"])
    nev = int(ptree["ev.m"])
    block = int(ptree["ev.block"])
    m = -(-nev // block) * block
    extra: dict = {}
    A, B = _problem_pair(ptree)

    if method == "raes":
        from dune_eigensolver_tpu.solvers import generalized_inverse

        res, t = _timed(
            lambda: generalized_inverse(
                A,
                B,
                nev=m,
                tol=float(ptree["ev.tol"]),
                maxiter=int(ptree["ev.maxiter"]),
                shift=float(ptree["ev.shift"]),
                reg=float(ptree["ev.regularization"]),
                block=block,
                seed=int(ptree["ev.seed"]),
                inverse=_inverse_factory(ptree),
                rayleigh_ritz=bool(ptree.get("ev.rr", False)),
            )
        )
        ev = np.asarray(res.eigenvalues)
        iters = int(res.iterations)
    elif method == "lobpcg":
        from dune_eigensolver_tpu.solvers import lobpcg_generalized

        b_identity = bool(int(ptree.get("ev.b_identity", 0)))
        if b_identity and int(ptree["ev.dim"]) != 3:
            # fetch-free structural guard: ev.b_identity skips ALL
            # B-applies, which is only valid for the identity pencil the
            # 3D protocol builds (identity_on_pattern); the 2D default B
            # is the GenEO mass matrix — honoring the flag there would
            # silently return wrong eigenvalues.
            raise ValueError(
                "ev.b_identity=1 requires the identity-pencil problem "
                "(ev.dim=3); the 2D protocol's B is the GenEO "
                "partition-of-unity mass matrix"
            )
        kwargs = dict(
            nev=m,
            tol=float(ptree["ev.tol"]),
            maxiter=int(ptree["ev.maxiter"]),
            shift=float(ptree["ev.shift"]),
            reg=float(ptree["ev.regularization"]),
            block=block,
            seed=int(ptree["ev.seed"]),
            precond=False if str(ptree["ev.inverse"]) == "none" else _inverse_factory(ptree),
            ortho_iterations=int(ptree.get("ev.ortho_iterations", 2)),
            ortho_block=(lambda s: None if s == "" else
                         ("full" if s == "full" else int(s)))(
                str(ptree.get("ev.ortho_block", ""))
            ),
            b_identity=b_identity,
        )
        if bool(int(ptree.get("ev.nested", 0))):
            # nested iteration (solvers/nested.py): coarse-grid hierarchy
            # seeds; needs the identity pencil (the solver validates) and a
            # structured-grid DIA operand. ev.coarse_tol default = tol/10.
            from dune_eigensolver_tpu.solvers import lobpcg_nested

            ct = str(ptree.get("ev.coarse_tol", ""))
            run = lambda: lobpcg_nested(  # noqa: E731
                A, B,
                min_coarse=int(ptree.get("ev.min_coarse", 48)),
                coarse_tol=float(ct) if ct else None,
                **kwargs,
            )
        else:
            run = lambda: lobpcg_generalized(A, B, **kwargs)  # noqa: E731
        res, t = _timed(run)
        ev = np.asarray(res.eigenvalues)
        iters = int(res.iterations)
    elif method == "dist":
        from dune_eigensolver_tpu.dist import make_mesh, sharded_generalized_inverse

        nd = int(ptree["parallel.ndevices"]) or len(jax.devices())
        res, t = _timed(
            lambda: sharded_generalized_inverse(
                A,
                B,
                nev=m,
                tol=float(ptree["ev.tol"]),
                maxiter=int(ptree["ev.maxiter"]),
                shift=float(ptree["ev.shift"]),
                mesh=make_mesh(nd),
                seed=int(ptree["ev.seed"]),
            )
        )
        ev = np.asarray(res.eigenvalues)
        iters = int(res.iterations)
    elif method == "dist_general":
        # the GENERAL-sparsity distributed path (dist/windowed.py): same
        # pencil, containers converted to scipy so the row-sharded ELL
        # SpMM serves the SpMMs
        from dune_eigensolver_tpu.dist import (
            make_mesh,
            sharded_generalized_inverse_general,
        )

        nd = int(ptree["parallel.ndevices"]) or len(jax.devices())
        res, t = _timed(
            lambda: sharded_generalized_inverse_general(
                A.to_scipy(),
                B.to_scipy(),
                nev=m,
                tol=float(ptree["ev.tol"]),
                maxiter=int(ptree["ev.maxiter"]),
                shift=float(ptree["ev.shift"]),
                mesh=make_mesh(nd),
                seed=int(ptree["ev.seed"]),
                cg_rtol=1e-8,
                cg_maxiter=500,
                inner=str(ptree.get("ev.dist_inner", "schwarz")),
            )
        )
        ev = np.asarray(res.eigenvalues)
        iters = int(res.iterations)
    elif method == "adaptive":
        # GenEO coarse-space selection (arpack_geneo_wrapper.hh:661-774):
        # grow nev by ev.growth until lambda_max >= ev.threshold.
        from dune_eigensolver_tpu.solvers import generalized_inverse_adaptive

        (res, n_below), t = _timed(
            lambda: generalized_inverse_adaptive(
                A,
                B,
                threshold=float(ptree["ev.threshold"]),
                nev=m,
                tol=float(ptree["ev.tol"]),
                maxiter=int(ptree["ev.maxiter"]),
                shift=float(ptree["ev.shift"]),
                reg=float(ptree["ev.regularization"]),
                growth=float(ptree["ev.growth"]),
                block=block,
                seed=int(ptree["ev.seed"]),
                verbose=int(ptree["ev.verbose"]),
            )
        )
        ev = np.asarray(res.eigenvalues)
        iters = int(res.iterations)
        m = ev.size  # final (possibly grown) block; RESULT line reports it
        extra = dict(n_below=n_below)
        _log(ptree, 1, f"  adaptive: m_final={ev.size} n_below={n_below}")
    elif method == "arpack":
        from dune_eigensolver_tpu.oracle.scipy_oracle import smallest_generalized

        t0 = time.perf_counter()
        ev, _ = smallest_generalized(
            A, B, m, sigma=-float(ptree["ev.shift"]), tol=float(ptree["ev.tol"])
        )
        t = time.perf_counter() - t0
        iters = -1
    else:
        raise ValueError(f"unknown ev.method={method!r}")

    _log(ptree, 1, f"  eigenvalues: {np.sort(ev)[:6]}")
    print(
        f"RESULT eigenvalues_test {method} N={ptree['ev.N']} m={m} "
        f"iters={iters} time={t:.3f}s",
        flush=True,
    )
    return dict(time=t, iterations=iters, eigenvalues=np.sort(ev)[:m], **extra)


# ---------------------------------------------------------------------------
# Kernel benchmarks
# ---------------------------------------------------------------------------


def _bench_op(fn, x0, n_iter: int, reps: int = 3, op_args=()) -> float:
    """Time per application of the self-composable ``fn(x, *op_args)``:
    n_iter applications chained inside ONE jit (bench/timing.py). Operands
    go through ``op_args`` (jit arguments), never closures."""
    from dune_eigensolver_tpu.bench.timing import bench_loop

    return bench_loop(
        lambda x, *a: fn(x, *a), x0, K=n_iter, reps=reps, op_args=op_args
    )


def mgs_performance_test(ptree) -> dict:
    """Reference cc:164-311: orthonormalization throughput, naive (block=1
    column MGS) vs blocked (Cholesky-QR per block), with the roofline
    models. Result line mirrors ``P_n_m_i_iblocked_perfn_perfb_perfv``."""
    from dune_eigensolver_tpu.bench.models import (
        bytes_orthonormalize_blocked,
        bytes_orthonormalize_naive,
        flops_orthonormalize,
    )
    from dune_eigensolver_tpu.ops.ortho import orthonormalize_blocked

    n = 1 << int(ptree["mgs.n"])
    m = int(ptree["mgs.m"])
    n_iter = int(ptree["mgs.n_iter"])
    dt = _dtype(ptree)
    key = jax.random.PRNGKey(int(ptree["ev.seed"]))
    X = jax.random.normal(key, (n, m), dtype=dt)

    t_naive = _bench_op(lambda V: orthonormalize_blocked(V, block=1), X, n_iter=n_iter)
    block = int(ptree["ev.block"])
    t_blocked = _bench_op(
        lambda V: orthonormalize_blocked(V, block=block), X, n_iter=n_iter
    )

    fl = flops_orthonormalize(n, m)
    gf_n, gf_b = fl / t_naive / 1e9, fl / t_blocked / 1e9
    int_n = fl / bytes_orthonormalize_naive(n, m, dt.itemsize)
    int_b = fl / bytes_orthonormalize_blocked(n, m, block, dt.itemsize)
    _log(ptree, 1, f"  naive:   {t_naive*1e6:.0f}us  {gf_n:.1f} GFLOP/s  AI={int_n:.2f}")
    _log(ptree, 1, f"  blocked: {t_blocked*1e6:.0f}us  {gf_b:.1f} GFLOP/s  AI={int_b:.2f}")
    print(
        f"P_n_m_i_perfn_perfb: 1 {n} {m} {n_iter} {gf_n:.2f} {gf_b:.2f}",
        flush=True,
    )
    return dict(gflops_naive=gf_n, gflops_blocked=gf_b)


def matvec_performance_test(ptree) -> dict:
    """Reference cc:315-427 (disabled there for lack of a generator; active
    here): tall-skinny SpMM throughput. DIA: the plain XLA formulations
    and ``padded_spmm`` on the guarded layout (the solvers' hot loop);
    general sparsity: the XLA ELL/BSR gathers on the elasticity operator."""
    from dune_eigensolver_tpu.bench.models import bytes_spmm_dia, flops_spmm
    from dune_eigensolver_tpu.kernels.dia_spmm import (
        PaddedDIA,
        PaddedLayout,
        dia_spmm_t_xla,
        padded_spmm,
    )
    from dune_eigensolver_tpu.sparse import problems
    from dune_eigensolver_tpu.sparse.formats import (
        DIAMatrix,
        bsr_from_scipy,
        ell_from_scipy,
    )
    from dune_eigensolver_tpu.sparse.spmm import spmm, spmm_t

    N = int(ptree["ev.N"])
    m = int(ptree["mv.m"])
    dt = _dtype(ptree)
    A = problems.laplacian_dirichlet_2d(N, dtype=dt)
    A = DIAMatrix(data=A.data / 8.0, offsets=A.offsets, shape=A.shape)
    n, nnz = A.shape[0], A.nnz
    key = jax.random.PRNGKey(0)
    X = jax.random.normal(key, (n, m), dtype=dt)
    Xt = jnp.asarray(X.T)
    # the solver hot-loop formulation: persistent guarded layout, padded
    # ONCE outside the loop — what solvers/engine.py runs
    L = PaddedLayout(n, m, A.offsets)
    Apd = L.pad_operator(A)

    def step_padded(x, pdata):
        return padded_spmm(PaddedDIA(pdata, A.offsets, A.shape, L.G), x)

    results = {}
    variants = [
        ("xla", lambda V, M: spmm(M, V), X, (A,)),
        ("xla_t", lambda V, M: dia_spmm_t_xla(M, V), Xt, (A,)),
        ("padded", step_padded, L.pad(Xt), (Apd.data,)),
    ]
    for name, fn, x0, op_args in variants:
        t = _bench_op(fn, x0, n_iter=20, op_args=op_args)
        gf = flops_spmm(nnz, m) / t / 1e9
        gb = bytes_spmm_dia(n, len(A.offsets), m, dt.itemsize) / t / 1e9
        results[name] = gf
        print(
            f"RESULT {name} {n} {nnz} {m} {gf:.2f} GFLOP/s {gb:.1f} GB/s",
            flush=True,
        )

    # general sparsity on the elasticity BSR operator and its scalar ELL
    # expansion — the operand class the reference streams as raw CSR/BCRS
    # (kernels_cpp.hh:626-657)
    Ab, _ = problems.elasticity_2d(max(2, N // 2), dtype=dt)
    Sa = Ab.to_scipy()
    # normalize so chained bench applications stay bounded
    Sa = Sa / float(np.abs(Sa).sum(axis=1).max())
    Ab = bsr_from_scipy(Sa, block=Ab.block, dtype=dt)
    Ae = ell_from_scipy(Sa, dtype=dt)
    Xg = jax.random.normal(key, (m, Ab.shape[0]), dtype=dt)
    for name, M in (("bsr_xla", Ab), ("ell_xla", Ae)):
        t = _bench_op(lambda V, _op: spmm_t(_op, V), Xg, n_iter=20,
                      op_args=(M,))
        gf = flops_spmm(M.nnz, m) / t / 1e9
        # effective bytes: coefficients+indices once, X and Y once
        bts = (2 * M.nnz + 2 * M.shape[0] * m) * dt.itemsize
        results[name] = gf
        print(
            f"RESULT {name} {M.shape[0]} {M.nnz} {m} "
            f"{gf:.2f} GFLOP/s {bts / t / 1e9:.1f} GB/s",
            flush=True,
        )
    return results


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def _scaling_test(ptree):
    from dune_eigensolver_tpu.bench.scaling import scaling_test

    return scaling_test(ptree)


TESTS = {
    "largest": largest_eigenvalues_convergence_test,
    "smallest": smallest_eigenvalues_convergence_test,
    "eigenvalues": eigenvalues_test,
    "mgs": mgs_performance_test,
    "matvec": matvec_performance_test,
    "scaling": _scaling_test,
}


class UnknownTest(ValueError):
    pass


def run(argv: list) -> dict:
    """Parse ``[ini-file] [sec.key=value ...] [--test NAME]``, run the
    tests and return each one's result dict by name. Raises UnknownTest
    for a test name not in TESTS."""
    argv = list(argv)
    test = "largest"  # the test the reference main() runs (cc:777)
    if "--test" in argv:
        i = argv.index("--test")
        test = argv[i + 1]
        del argv[i : i + 2]
    ptree = ParameterTree()
    if argv and "=" not in argv[0]:
        ptree.read_ini(argv.pop(0))
    ptree.read_cli(argv)

    if _dtype(ptree) == np.float64:
        # f64 iteration needs x64 on before any array is built (global)
        jax.config.update("jax_enable_x64", True)
    if int(ptree.get("ev.compile_cache", 1)):
        # persistent executable cache (utils/compile_cache.py)
        from dune_eigensolver_tpu.utils.compile_cache import (
            enable_compile_cache,
        )

        enable_compile_cache()

    dev = jax.devices()[0]
    _log(ptree, 1, f"device: {dev.device_kind} platform={dev.platform}")
    _log(ptree, 2, repr(ptree))

    if int(ptree.get("ev.paranoid", 0)):
        # runtime NaN tripwire on every kernel dispatch (utils/paranoid.py)
        from dune_eigensolver_tpu.utils.paranoid import set_paranoid

        set_paranoid(True)

    if test != "all" and test not in TESTS:
        raise UnknownTest(
            f"unknown test {test!r}; choose from {sorted(TESTS)} or 'all'"
        )
    names = list(TESTS) if test == "all" else [test]
    from dune_eigensolver_tpu.utils.vlog import profiler_trace

    results = {}
    with profiler_trace(ptree.get("ev.profile_dir")):
        for name in names:
            _log(ptree, 1, f"== {name} ==")
            results[name] = TESTS[name](ptree)
    return results


def main(argv: Optional[list] = None) -> int:
    try:
        run(sys.argv[1:] if argv is None else argv)
    except UnknownTest as e:
        print(e)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
