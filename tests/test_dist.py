"""Multi-chip paths on the simulated 8-device CPU mesh: halo-exchange SpMM
equals the single-chip SpMM; sharded solvers equal the single-chip solvers."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dune_eigensolver_tpu.dist import (
    dia_spmm_halo,
    make_mesh,
    sharded_generalized_inverse,
    sharded_standard_largest,
)
from dune_eigensolver_tpu.factorize.cg import cg_inverse_factory
from dune_eigensolver_tpu.oracle import eigenvalues_laplace_dirichlet_2d
from dune_eigensolver_tpu.solvers import generalized_inverse, standard_largest
from dune_eigensolver_tpu.sparse import problems
from dune_eigensolver_tpu.sparse.spmm import spmm


def test_dia_spmm_halo_matches_single_chip(rng):
    N = 16  # n = 256 = 8 * 32, halo 16 <= 32 local rows
    A = problems.laplacian_dirichlet_2d(N)
    n = A.shape[0]
    X = jnp.asarray(rng.normal(size=(n, 8)))
    ref = np.asarray(spmm(A, X))

    mesh = make_mesh(8)
    fn = jax.jit(
        jax.shard_map(
            lambda ad, x: dia_spmm_halo(ad, A.offsets, x),
            mesh=mesh,
            in_specs=(P(None, "rows"), P("rows", None)),
            out_specs=P("rows", None),
        )
    )
    Ad = jax.device_put(A.data, NamedSharding(mesh, P(None, "rows")))
    Xs = jax.device_put(X, NamedSharding(mesh, P("rows", None)))
    out = np.asarray(fn(Ad, Xs))
    assert np.abs(out - ref).max() < 1e-12


def test_halo_bandwidth_guard():
    # n=64 over 8 shards -> nloc=8; a bandwidth-9 stencil must be rejected
    mesh = make_mesh(8)
    from dune_eigensolver_tpu.dist.sharded import dia_spmm_halo as f

    with pytest.raises(ValueError):
        jax.jit(
            jax.shard_map(
                lambda ad, x: f(ad, (-9, 0, 9), x),
                mesh=mesh,
                in_specs=(P(None, "rows"), P("rows", None)),
                out_specs=P("rows", None),
            )
        )(jnp.zeros((3, 64)), jnp.zeros((64, 8)))


def test_sharded_standard_largest_matches_single():
    N = 16
    A = problems.laplacian_dirichlet_2d(N)
    res_s = sharded_standard_largest(A, nev=4, tol=1e-10, maxiter=2000, mesh=make_mesh(8))
    res_1 = standard_largest(A, nev=4, tol=1e-10, maxiter=2000)
    ana = eigenvalues_laplace_dirichlet_2d(N)[::-1][:4]
    assert np.abs(np.asarray(res_s.eigenvalues) - ana).max() < 2e-3
    assert (
        np.abs(np.asarray(res_s.eigenvalues) - np.asarray(res_1.eigenvalues)).max()
        < 1e-8
    )


def test_sharded_generalized_matches_single():
    N, overlap, shift = 16, 3, 1e-3
    A = problems.laplacian_neumann_2d(N)
    B = problems.laplacian_b_2d(N, overlap)
    res_s = sharded_generalized_inverse(
        A, B, nev=4, tol=2e-3, maxiter=500, shift=shift,
        mesh=make_mesh(8), cg_rtol=1e-10,
    )
    res_1 = generalized_inverse(
        A, B, nev=4, tol=2e-3, maxiter=500, shift=shift,
        inverse=cg_inverse_factory(rtol=1e-10, maxiter=2000),
    )
    assert (
        np.abs(np.asarray(res_s.eigenvalues) - np.asarray(res_1.eigenvalues)).max()
        < 1e-6
    )


def test_sharded_lobpcg_matches_oracle():
    from dune_eigensolver_tpu.dist import sharded_lobpcg_generalized
    from dune_eigensolver_tpu.oracle import smallest_generalized

    N, overlap, shift = 16, 3, 1e-3
    A = problems.laplacian_neumann_2d(N)
    B = problems.laplacian_b_2d(N, overlap)
    res_s = sharded_lobpcg_generalized(
        A, B, nev=4, tol=1e-6, maxiter=300, shift=shift, mesh=make_mesh(8)
    )
    truth, _ = smallest_generalized(A, B, 4, sigma=-shift, tol=1e-14)
    assert np.abs(np.asarray(res_s.eigenvalues)[:4] - truth).max() < 2e-3


def test_sharded_lobpcg_bf16_precond_matches_oracle():
    """prec_dtype=bfloat16: the inner CG streams bf16 per shard (and over
    the halo exchange) while the outer Rayleigh-Ritz stays f32 — the
    distributed form of the single-chip north-star recipe."""
    from dune_eigensolver_tpu.dist import sharded_lobpcg_generalized
    from dune_eigensolver_tpu.oracle import smallest_generalized

    N, overlap, shift = 16, 3, 1e-3
    A = problems.laplacian_neumann_2d(N, dtype=np.float32)
    B = problems.laplacian_b_2d(N, overlap, dtype=np.float32)
    res = sharded_lobpcg_generalized(
        A, B, nev=4, tol=1e-6, maxiter=300, shift=shift, mesh=make_mesh(8),
        prec_dtype=jnp.bfloat16,
    )
    truth, _ = smallest_generalized(A, B, 4, sigma=-shift, tol=1e-14)
    assert np.abs(np.asarray(res.eigenvalues)[:4] - truth).max() < 2e-3


def test_sharded_lobpcg_3d_matches_analytic():
    """The multi-chip north-star path: sharded LOBPCG on the 3D 7-point
    Laplacian (the BASELINE.md 10M-dof problem, shrunk) against the
    closed-form Dirichlet spectrum."""
    from dune_eigensolver_tpu.dist import sharded_lobpcg_generalized
    from dune_eigensolver_tpu.oracle.analytic import (
        eigenvalues_laplace_dirichlet_3d,
    )
    from dune_eigensolver_tpu.sparse.formats import DIAMatrix

    N = 8  # n = 512 rows, 128 per shard on 4 devices; halos at +-N^2 = 64
    A = problems.laplacian_dirichlet_3d(N, dtype=np.float32)
    n = A.shape[0]
    B = DIAMatrix(data=jnp.ones((1, n), np.float32), offsets=(0,), shape=A.shape)
    res = sharded_lobpcg_generalized(
        A, B, nev=8, tol=1e-7, maxiter=400, shift=0.0, mesh=make_mesh(4)
    )
    ana = eigenvalues_laplace_dirichlet_3d(N, count=8)
    assert np.abs(np.sort(np.asarray(res.eigenvalues))[:8] - ana).max() < 2e-3


def test_schwarz_preconditioner_cuts_inner_iterations():
    """The additive-Schwarz inner engine (exact per-shard banded block
    solves preconditioning a global CG) must converge in far fewer
    dot-bearing iterations than plain Jacobi-CG — the distributed analogue
    of the reference's direct factorization (umfpacktools.hh:16-220)."""
    from functools import partial

    from dune_eigensolver_tpu.dist import make_mesh, psum_reduce
    from dune_eigensolver_tpu.dist.sharded import (
        dia_spmm_halo_t,
        local_diag_block,
    )
    from dune_eigensolver_tpu.factorize.banded import (
        banded_solve,
        factorize_banded_device,
    )
    from dune_eigensolver_tpu.factorize.cg import cg_solve_t
    from dune_eigensolver_tpu.sparse.formats import DIAMatrix

    N = 32
    A = problems.laplacian_dirichlet_2d(N).with_shifted_diagonal(1e-3)
    n = A.shape[0]
    mesh = make_mesh(8)
    rng = np.random.default_rng(0)
    Bt = jnp.asarray(rng.normal(size=(4, n)))
    axis = mesh.axis_names[0]

    def iters(adata, bt, use_schwarz):
        apply_a = partial(dia_spmm_halo_t, adata, A.offsets, axis=axis)
        reduce_ = psum_reduce(axis)
        if use_schwarz:
            blk = local_diag_block(adata, A.offsets)
            F = factorize_banded_device(
                DIAMatrix(data=blk, offsets=A.offsets,
                          shape=(blk.shape[1], blk.shape[1]))
            )
            _, k = cg_solve_t(
                apply_a, bt, rtol=1e-8, maxiter=2000, gram_reduce=reduce_,
                precond_apply=lambda R: banded_solve(F, R.T).T,
            )
        else:
            inv_diag = 1.0 / adata[A.offsets.index(0)]
            _, k = cg_solve_t(
                apply_a, bt, inv_diag=inv_diag, rtol=1e-8, maxiter=2000,
                gram_reduce=reduce_,
            )
        return jax.lax.psum(k, axis) // mesh.devices.size

    from jax.sharding import PartitionSpec as P  # noqa: N817

    run = jax.jit(
        jax.shard_map(
            partial(iters, use_schwarz=True), mesh=mesh,
            in_specs=(P(None, axis), P(None, axis)), out_specs=P(),
        )
    )
    run_plain = jax.jit(
        jax.shard_map(
            partial(iters, use_schwarz=False), mesh=mesh,
            in_specs=(P(None, axis), P(None, axis)), out_specs=P(),
        )
    )
    k_schwarz = int(run(A.data, Bt))
    k_plain = int(run_plain(A.data, Bt))
    # measured on the 8-device CPU mesh: 43 vs 101 (~2.4x fewer)
    assert k_schwarz * 2 < k_plain, (k_schwarz, k_plain)


def test_sharded_standard_inverse_schwarz_matches_single():
    from dune_eigensolver_tpu.dist import sharded_standard_inverse
    from dune_eigensolver_tpu.solvers import standard_inverse

    N, shift = 16, 1e-3
    A = problems.laplacian_dirichlet_2d(N)
    res_s = sharded_standard_inverse(
        A, nev=4, tol=1e-10, maxiter=500, shift=shift,
        mesh=make_mesh(8), cg_rtol=1e-10, inner="schwarz",
    )
    res_1 = standard_inverse(A, nev=4, tol=1e-10, maxiter=500, shift=shift)
    assert (
        np.abs(np.asarray(res_s.eigenvalues) - np.asarray(res_1.eigenvalues)).max()
        < 1e-6
    )


def test_padded_spmm_halo_matches_single_chip(rng):
    """The spmm='padded' hot path (per-shard guarded Pallas kernel +
    ppermute edge corrections) must reproduce the single-chip SpMM.
    Interpret-mode Pallas on the CPU mesh; f32 kernel accumulation."""
    from functools import partial

    from dune_eigensolver_tpu.dist.sharded import _ShardEngine

    N = 16
    A = problems.laplacian_dirichlet_2d(N)
    n = A.shape[0]
    Xt = jnp.asarray(rng.normal(size=(n, 8))).T
    ref = np.asarray(spmm(A, Xt.T))

    mesh = make_mesh(8)
    axis = mesh.axis_names[0]

    def local(adata, xloc):
        eng = _ShardEngine([adata], [A.offsets], 8, axis, "padded")
        Yp = eng.apply(0)(eng.pad_q0(xloc))
        L = eng.layout
        return jax.lax.slice(Yp, (0, L.G), (Yp.shape[0], L.G + L.n))

    fn = jax.jit(
        jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(None, axis), P(None, axis)),
            out_specs=P(None, axis), check_vma=False,
        )
    )
    Ad = jax.device_put(A.data, NamedSharding(mesh, P(None, axis)))
    Xs = jax.device_put(Xt, NamedSharding(mesh, P(None, axis)))
    out = np.asarray(fn(Ad, Xs)).T
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() / scale < 1e-6  # f32 kernel accumulation


def test_sharded_largest_padded_mode_matches_xla():
    """spmm='padded' and spmm='xla' must agree on the whole solve."""
    N = 16
    A = problems.laplacian_dirichlet_2d(N)
    kw = dict(nev=4, tol=1e-8, maxiter=2000, mesh=make_mesh(8))
    res_p = sharded_standard_largest(A, spmm="padded", **kw)
    res_x = sharded_standard_largest(A, spmm="xla", **kw)
    assert (
        np.abs(
            np.asarray(res_p.eigenvalues) - np.asarray(res_x.eigenvalues)
        ).max()
        < 1e-5
    )
    ana = eigenvalues_laplace_dirichlet_2d(N)[::-1][:4]
    assert np.abs(np.asarray(res_p.eigenvalues) - ana).max() < 2e-3


def test_sharded_generalized_padded_mode_matches_xla():
    N, overlap, shift = 16, 3, 1e-3
    A = problems.laplacian_neumann_2d(N)
    B = problems.laplacian_b_2d(N, overlap)
    kw = dict(
        nev=4, tol=2e-3, maxiter=500, shift=shift,
        mesh=make_mesh(8), cg_rtol=1e-8,
    )
    res_p = sharded_generalized_inverse(A, B, spmm="padded", **kw)
    res_x = sharded_generalized_inverse(A, B, spmm="xla", **kw)
    assert (
        np.abs(
            np.asarray(res_p.eigenvalues) - np.asarray(res_x.eigenvalues)
        ).max()
        < 1e-5
    )


def test_sharded_nondivisible_rows():
    """Row counts that do not divide the mesh size are padded with
    decoupled identity rows (reference BCRS accepts any n; so do we)."""
    N = 15  # n = 225, not divisible by 8
    A = problems.laplacian_dirichlet_2d(N)
    res_s = sharded_standard_largest(
        A, nev=4, tol=1e-10, maxiter=2000, mesh=make_mesh(8)
    )
    res_1 = standard_largest(A, nev=4, tol=1e-10, maxiter=2000)
    assert res_s.eigenvectors.shape == (225, 4)
    assert (
        np.abs(
            np.asarray(res_s.eigenvalues) - np.asarray(res_1.eigenvalues)
        ).max()
        < 1e-8
    )
    ana = eigenvalues_laplace_dirichlet_2d(N)[::-1][:4]
    assert np.abs(np.asarray(res_s.eigenvalues) - ana).max() < 2e-3


def test_sharded_generalized_nondivisible_rows():
    N, overlap, shift = 15, 3, 1e-3  # n = 225
    A = problems.laplacian_neumann_2d(N)
    B = problems.laplacian_b_2d(N, overlap)
    res_s = sharded_generalized_inverse(
        A, B, nev=4, tol=2e-3, maxiter=500, shift=shift,
        mesh=make_mesh(8), cg_rtol=1e-10,
    )
    res_1 = generalized_inverse(
        A, B, nev=4, tol=2e-3, maxiter=500, shift=shift,
        inverse=cg_inverse_factory(rtol=1e-10, maxiter=2000),
    )
    assert res_s.eigenvectors.shape == (225, 4)
    assert (
        np.abs(
            np.asarray(res_s.eigenvalues) - np.asarray(res_1.eigenvalues)
        ).max()
        < 1e-6
    )


def test_rect_laplacian_matches_square():
    Ar = problems.laplacian_dirichlet_rect(12, 12)
    As = problems.laplacian_dirichlet_2d(12)
    assert Ar.offsets == As.offsets
    assert np.allclose(np.asarray(Ar.data), np.asarray(As.data))


def test_connected_scaling_spmm_correct():
    # the connected weak-scaling operand must agree with the single-chip
    # SpMM — the halo rows carry real couplings here
    from dune_eigensolver_tpu.bench.scaling import weak_scaling_spmm

    recs = weak_scaling_spmm(
        rows_per_device=256, m=8, n_iter=2, device_counts=[1, 4, 8],
        coupling="connected",
    )
    assert [r["devices"] for r in recs] == [1, 4, 8]
    Nloc = 16
    A = problems.laplacian_dirichlet_rect(Nloc, Nloc * 8)
    n = A.shape[0]
    mesh = make_mesh(8)
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.normal(size=(n, 8)))
    from functools import partial

    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    f = jax.jit(
        jax.shard_map(
            partial(dia_spmm_halo, axis=axis),
            mesh=mesh,
            in_specs=(P(None, axis), None, P(axis, None)),
            out_specs=P(axis, None),
        ),
        static_argnums=(1,),
    )
    Y = f(A.data, A.offsets, X)
    Yref = spmm(A, X)
    assert np.abs(np.asarray(Y) - np.asarray(Yref)).max() < 1e-10


def test_weak_scaling_solver_phases_padded():
    # solver sweep in the engine's padded mode with the per-phase breakdown
    # (VERDICT r3 asks #7): phase columns exist, are positive, and roughly
    # compose the full iteration (each phase <= full; sum within ~3x of
    # full given per-program overheads on the CPU mesh)
    from dune_eigensolver_tpu.bench.scaling import weak_scaling_solver

    recs = weak_scaling_solver(
        rows_per_device=256, m=8, n_iter=2, device_counts=[1, 2],
        coupling="connected", inner="cg", inner_iters=4,
        spmm="padded", phases=True,
    )
    assert [r["devices"] for r in recs] == [1, 2]
    for r in recs:
        assert r["mode"] == "padded"
        for ph in ("spmm", "inner", "ortho", "rayleigh"):
            assert r[f"t_{ph}"] > 0
        assert r["t_inner"] < 3 * r["t_iter"]


def test_sharded_program_cache_reuse():
    # repeat solves with identical static config must reuse the jitted
    # shard_map program (a fresh closure per call would re-trace and
    # recompile every solve)
    from dune_eigensolver_tpu.dist import sharded as sh

    A = problems.laplacian_dirichlet_2d(16, dtype=np.float32)
    mesh = make_mesh(2)
    kw = dict(nev=4, tol=1e-6, maxiter=30, mesh=mesh, spmm="xla")
    sh._PROGRAM_CACHE.clear()
    r1 = sharded_standard_largest(A, **kw)
    n_after_first = len(sh._PROGRAM_CACHE)
    r2 = sharded_standard_largest(A, **kw)
    assert len(sh._PROGRAM_CACHE) == n_after_first == 1
    np.testing.assert_allclose(
        np.asarray(r1.eigenvalues), np.asarray(r2.eigenvalues)
    )
    # different static config -> new program
    sharded_standard_largest(A, nev=4, tol=1e-5, maxiter=30, mesh=mesh,
                             spmm="xla")
    assert len(sh._PROGRAM_CACHE) == 2


def test_scaling_efficiency_noise_floor_guard():
    # a per-iteration time at the timer noise floor must report
    # efficiency=nan, never an absurd ratio (an earlier sweep printed
    # eff=20611458 from a 0 us time)
    from dune_eigensolver_tpu.bench.scaling import _EFF_FLOOR, _efficiency

    assert _efficiency(1e-3, 1e-3) == 1.0
    assert np.isnan(_efficiency(1e-3, _EFF_FLOOR / 2))  # t at floor
    assert np.isnan(_efficiency(_EFF_FLOOR / 2, 1e-3))  # baseline at floor
    assert np.isnan(_efficiency(None, 1e-3))
