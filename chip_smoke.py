"""Smoke run of the eigensolvers on one NVIDIA GPU (or, with ``--four``, the
sharded drivers on a four-card mesh).

Drives the main path through the entry points a user calls, at the sizes
users run, and checks every result against an independent reference:

1. DIA SpMM: the Pallas kernel (``padded_spmm``) at 2D n = 4,194,304, m = 8
   (float32, bfloat16) and 3D N = 216, m = 24, against the plain reference
   ``sparse.spmm.dia_spmm`` on the card and a float64 numpy evaluation of
   4096 sampled rows on the host.
2. General SpMM: ``bsr_spmm_t`` on ``elasticity_2d(512)`` (n = 522,242) at
   m = 8 and m = 128 against scipy CSR @ X in float64.
3. GenEO: ``generalized_inverse`` on the n = 65,536 pencil, nev = 8,
   against the scipy/ARPACK oracle, with residuals.
4. LOBPCG on the same pencil with a loose CG preconditioner.
5. Elasticity pencil ``elasticity_2d(512)`` (n = 522,242) through the
   engine's general path (BSR SpMM, banded direct inverse), against the
   oracle, with residuals.
6. North star: smallest 20 eigenpairs of the N = 216 3D Laplacian
   (n = 10,077,696) by nested LOBPCG, against the analytic spectrum.
7. CLI: ``cli.run`` in process, ``--test largest``, then ``--test
   smallest`` with ``ev.dtype=float64`` (last: x64 is global).

``--four`` runs only the sharded drivers on four cards and what they are
compared with. Every phase prints one line with its numbers, its seconds
and the card; a failed check raises. The last line of stdout is one JSON
object naming the device. Exits non-zero, with no result line, when JAX
finds no GPU.

Usage: ``python chip_smoke.py [--four]``
"""

import json
import sys
import time

import numpy as np


def _log(phase, t0, **nums):
    print(f"[{phase}] {time.perf_counter() - t0:.2f}s "
          + " ".join(f"{k}={v}" for k, v in nums.items()) + f" | {CARD}",
          flush=True)


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _residuals(A, B, lam, V):
    """max_j ||A v_j - lam_j B v_j|| / (||A||_inf ||v_j||) in float64 on
    the host (B None: identity)."""
    As = A.to_scipy().astype(np.float64)
    V = np.asarray(V, np.float64)
    AV = As @ V
    BV = V if B is None else B.to_scipy().astype(np.float64) @ V
    R = AV - BV * np.asarray(lam, np.float64)[None, :]
    a_inf = float(abs(As).sum(axis=1).max())
    return float((np.linalg.norm(R, axis=0)
                  / (a_inf * np.linalg.norm(V, axis=0))).max())


# Limits of the solver phases: (eigenvalues, residuals) for each.
# * eigenvalues: max |lam - ref| / max |ref| against the oracle or the
#   analytic spectrum;
# * residuals: the backward error max_j ||A v_j - lam_j B v_j|| /
#   (||A||_inf ||v_j||). Normalizing by ||A|| rather than ||A v|| keeps it
#   defined for the GenEO pencil's zero eigenvalue (Neumann null space).
# The shift-invert phases diagonalize the projected pencil (rayleigh_ritz):
# with the reference's per-column Rayleigh quotients, a block exactly nev
# wide leaves the pairs of a near-degenerate cluster mixed when the
# relative-change stop (tol = 2e-3) fires, about 1e-2 off the oracle.
# Each limit sits a few times above the reading of a sound run on the card
# and, where the two readings separate, below the reading of the same phase
# with every float32 product in TF32 (sound / TF32 readings, H100 700 W,
# PERF.md, Findings):
# * GenEO shift-invert: 3.2e-4 / 3.0e-3 and residual 8.0e-6 / 1.8e-4;
# * GenEO LOBPCG: 1.31e-3 / 1.39e-3 (the stop rule dominates both) and
#   residual 5.3e-5 / 1.5e-4, so the residual limit is the one that bites;
# * elasticity: 3.6e-5 / 4.3 and residual 3.8e-8 / 1.8e-4;
# * north star: 2.6e-4 / 1.4e-3 (3.2e-4 on a 400 W card) and residual
#   1.4e-4 / 2.4e-4: the eigenvalue limit bites, the residual one only
#   bounds gross failures;
# * four cards: the sharded drivers reproduce the single-card readings (the
#   same seeds and semantics) but invert by CG to rtol 1e-6, so their
#   limits sit below the single-card TF32 readings with more room above;
#   the sharded LOBPCG on the 3D Laplacian read 2.4e-3.
LIMITS = {
    "geneo generalized_inverse": (1e-3, 4e-5),
    "geneo lobpcg cg25": (3e-3, 1e-4),
    "elasticity generalized_inverse": (2e-4, 1e-6),
    "north_star lobpcg_nested": (7e-4, 5e-4),
    "four: sharded_lobpcg_generalized mg 3d": (7e-3, None),
    "four: sharded_generalized_inverse geneo": (2e-3, 1e-4),
    "four: sharded_generalized_inverse_general elasticity": (2e-4, 1e-5),
}


def _check_limits(name, err, res=None):
    eig_lim, res_lim = LIMITS[name]
    _check(err <= eig_lim, f"{name}: eigenvalue error {err:.2e} > {eig_lim}")
    if res_lim is not None:
        _check(res <= res_lim, f"{name}: residual {res:.2e} > {res_lim}")


def phase_dia(N2=2048, N3=216):
    import jax
    import jax.numpy as jnp

    from dune_eigensolver_tpu.kernels.dia_spmm import PaddedLayout, padded_spmm
    from dune_eigensolver_tpu.sparse import problems
    from dune_eigensolver_tpu.sparse.spmm import dia_spmm

    # tolerances: float32 max|dY| <= 1e-5 max|Y| (a handful of FMAs in
    # float32, summed in another order than the reference); bfloat16
    # operands <= 2e-2 (8-bit mantissa storage of X, A and Y)
    cases = [("2d", N2, 8, jnp.float32, 1e-5), ("2d", N2, 8, jnp.bfloat16, 2e-2),
             ("3d", N3, 24, jnp.float32, 1e-5)]
    for dim, N, m, dt, tol in cases:
        t0 = time.perf_counter()
        A = (problems.laplacian_dirichlet_2d(N, dtype=np.float32) if dim == "2d"
             else problems.laplacian_dirichlet_3d(N, dtype=np.float32))
        A = type(A)(A.data.astype(dt), A.offsets, A.shape)
        n = A.shape[0]
        Xt = jax.random.normal(jax.random.PRNGKey(0), (m, n), dt)
        L = PaddedLayout(n, m, A.offsets)
        Y = L.unpad(padded_spmm(L.pad_operator(A), L.pad(Xt)), m)
        Yref = dia_spmm(A, Xt.T).T
        scale = float(jnp.max(jnp.abs(Yref.astype(jnp.float32))))
        d_dev = float(jnp.max(jnp.abs(Y.astype(jnp.float32)
                                      - Yref.astype(jnp.float32)))) / scale
        rows = np.random.default_rng(0).choice(n, min(n, 4096), replace=False)
        data = np.asarray(A.data.astype(jnp.float32), np.float64)
        Xh = np.asarray(Xt.astype(jnp.float32), np.float64)
        ref = np.zeros((m, rows.size))
        for d, off in enumerate(A.offsets):
            c = rows + off
            ok = (c >= 0) & (c < n)
            ref[:, ok] += data[d, rows[ok]] * Xh[:, c[ok]]
        got = np.asarray(Y.astype(jnp.float32), np.float64)[:, rows]
        d_host = float(np.abs(got - ref).max() / np.abs(ref).max())
        _log(f"dia_spmm {dim} {jnp.dtype(dt).name}", t0, n=n, m=m,
             rel_vs_dia_spmm=f"{d_dev:.2e}", rel_vs_f64_rows=f"{d_host:.2e}",
             tol=tol)
        _check(d_dev <= tol and d_host <= tol, f"dia_spmm {dim} {dt}")
        del A, Xt, Y, Yref


def phase_general(N=512):
    import jax
    import jax.numpy as jnp

    from dune_eigensolver_tpu.sparse import problems
    from dune_eigensolver_tpu.sparse.spmm import bsr_spmm_t

    A, _ = problems.elasticity_2d(N, dtype=np.float32)
    S = A.to_scipy().astype(np.float64)
    n = A.shape[0]
    # tolerance 1e-5 relative: the block contraction runs at HIGHEST
    # precision (no TF32), so only float32 rounding of the sums remains
    for m in (8, 128):
        t0 = time.perf_counter()
        Xt = jax.random.normal(jax.random.PRNGKey(1), (m, n), jnp.float32)
        Y = np.asarray(bsr_spmm_t(A, Xt), np.float64)
        ref = (S @ np.asarray(Xt, np.float64).T).T
        rel = _rel_max(Y, ref)
        _log("bsr_spmm", t0, n=n, nnz=A.nnz, m=m, rel_vs_scipy=f"{rel:.2e}",
             tol=1e-5)
        _check(rel <= 1e-5, f"bsr_spmm m={m}")


def phase_geneo(N=256):
    import jax

    from dune_eigensolver_tpu.factorize import cg_inverse_factory
    from dune_eigensolver_tpu.oracle.scipy_oracle import smallest_generalized
    from dune_eigensolver_tpu.solvers import (
        generalized_inverse,
        lobpcg_generalized,
    )
    from dune_eigensolver_tpu.sparse import problems

    A = problems.laplacian_neumann_2d(N, dtype=np.float32)
    B = problems.laplacian_b_2d(N, 3, dtype=np.float32)
    ref, _ = smallest_generalized(A, B, 8, sigma=-1e-3)
    runs = [
        ("geneo generalized_inverse",
         lambda: generalized_inverse(A, B, nev=8, tol=2e-3, maxiter=200,
                                     shift=1e-3, rayleigh_ritz=True)),
        ("geneo lobpcg cg25",
         lambda: lobpcg_generalized(
             A, B, nev=8, tol=2e-3, maxiter=200, shift=1e-3,
             precond=cg_inverse_factory(rtol=1e-2, maxiter=25))),
    ]
    for name, run in runs:
        t0 = time.perf_counter()
        res = run()
        jax.block_until_ready(res.eigenvalues)
        t_first = time.perf_counter() - t0
        t1 = time.perf_counter()
        res = run()
        jax.block_until_ready(res.eigenvalues)
        t_steady = time.perf_counter() - t1
        lam = np.asarray(res.eigenvalues, np.float64)
        err = _rel_max(np.sort(lam), ref)
        r = _residuals(A, B, lam, res.eigenvectors)
        _log(name, t0, n=A.shape[0], nev=8, iters=int(res.iterations),
             first_call_s=f"{t_first:.3f}", steady_s=f"{t_steady:.3f}",
             rel_err=f"{err:.2e}", residual=f"{r:.2e}")
        _check_limits(name, err, r)


def phase_elasticity(N=512):
    import jax

    from dune_eigensolver_tpu.oracle.scipy_oracle import smallest_generalized
    from dune_eigensolver_tpu.solvers import generalized_inverse
    from dune_eigensolver_tpu.sparse import problems

    t0 = time.perf_counter()
    A, B = problems.elasticity_2d(N, dtype=np.float32)
    ref, _ = smallest_generalized(A, B, 4, sigma=-1e-3)

    def run():
        res = generalized_inverse(A, B, nev=4, tol=2e-3, maxiter=300,
                                  shift=1e-3, rayleigh_ritz=True)
        jax.block_until_ready(res.eigenvalues)
        return res

    t1 = time.perf_counter()
    run()
    t_first = time.perf_counter() - t1
    t1 = time.perf_counter()
    res = run()
    t_steady = time.perf_counter() - t1
    lam = np.asarray(res.eigenvalues, np.float64)
    err = _rel_max(np.sort(lam), ref)
    r = _residuals(A, B, lam, res.eigenvectors)
    name = "elasticity generalized_inverse"
    _log(name, t0, n=A.shape[0], nev=4, iters=int(res.iterations),
         first_call_s=f"{t_first:.3f}", steady_s=f"{t_steady:.3f}",
         rel_err=f"{err:.2e}", residual=f"{r:.2e}")
    _check_limits(name, err, r)


def phase_north_star(N=216):
    import jax
    import jax.numpy as jnp

    from dune_eigensolver_tpu.factorize import mg_inverse_factory
    from dune_eigensolver_tpu.oracle.analytic import (
        eigenvalues_laplace_dirichlet_3d,
    )
    from dune_eigensolver_tpu.solvers import lobpcg_nested
    from dune_eigensolver_tpu.sparse import problems
    from dune_eigensolver_tpu.sparse.formats import DIAMatrix
    from dune_eigensolver_tpu.sparse.spmm import dia_spmm

    A = problems.laplacian_dirichlet_3d(N, dtype=np.float32)
    n = A.shape[0]
    B = DIAMatrix(jnp.ones((1, n), jnp.float32), (0,), A.shape)
    prec = mg_inverse_factory(nu1=1, nu2=1, dtype=jnp.bfloat16)

    def run():
        res = lobpcg_nested(
            A, B, nev=24, tol=2e-3, maxiter=300, shift=0.0, min_coarse=48,
            coarse_tol=2e-4, precond=prec, ortho_iterations=1,
            ortho_block=24, b_identity=True,
        )
        jax.block_until_ready(res.eigenvalues)
        return res

    t0 = time.perf_counter()
    run()
    t_first = time.perf_counter() - t0
    t1 = time.perf_counter()
    res = run()
    t_steady = time.perf_counter() - t1
    lam = np.asarray(res.eigenvalues, np.float64)
    order = np.argsort(lam)[:20]
    exact = eigenvalues_laplace_dirichlet_3d(N, count=20)
    err = _rel_max(lam[order], exact)
    V = res.eigenvectors[:, order]
    R = dia_spmm(A, V) - V * jnp.asarray(lam[order], jnp.float32)[None, :]
    a_inf = float(jnp.max(jnp.sum(jnp.abs(A.data), axis=0)))
    r = float(jnp.max(jnp.linalg.norm(R, axis=0)
                      / (a_inf * jnp.linalg.norm(V, axis=0))))
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    _log("north_star lobpcg_nested", t0, n=n, nev=20,
         iters=int(res.iterations), first_call_s=f"{t_first:.3f}",
         steady_s=f"{t_steady:.3f}", rel_err20=f"{err:.2e}",
         residual20=f"{r:.2e}", peak_bytes_in_use=peak)
    _check_limits("north_star lobpcg_nested", err, r)


# CLI limits. ``--test largest`` runs the reference protocol (per-column
# Rayleigh quotients, tol = 2e-3) whose stop leaves the largest eigenvalues
# of the 2D Laplacian (spectral radius about 8) 8.35e-2 off the oracle on
# the CPU and on the card alike; the limit bounds that truncation.
# ``--test smallest`` in float64 iterates to tol = 1e-10: the float64 route
# lands 4.8e-11 off the oracle, while the same run in float32 stalls at its
# rounding, 5.2e-8 off (both on the card), so the limit proves that x64
# took effect.
CLI_LARGEST_LIMIT = 0.1
CLI_F64_LIMIT = 1e-9


def phase_cli(N=100):
    from dune_eigensolver_tpu import cli

    base = ["dune-eigensolver.ini", f"ev.N={N}", "ev.verbose=0"]
    t0 = time.perf_counter()
    out = cli.run(base + ["--test", "largest"])["largest"]
    _log("cli --test largest", t0, iters=out["iterations"],
         dtype=out["dtype"], err_vs_oracle=f"{out['err_vs_oracle']:.3e}",
         limit=CLI_LARGEST_LIMIT)
    _check(out["err_vs_oracle"] <= CLI_LARGEST_LIMIT, "cli largest")
    t0 = time.perf_counter()
    out = cli.run(base + ["ev.dtype=float64", "ev.tol=1e-10",
                          "ev.maxiter=400", "--test", "smallest"])["smallest"]
    _log("cli --test smallest ev.dtype=float64", t0, iters=out["iterations"],
         dtype=out["dtype"], err_vs_truth=f"{out['err_vs_truth']:.3e}",
         limit=CLI_F64_LIMIT)
    _check(out["dtype"] == "float64", f"cli smallest ran in {out['dtype']}")
    _check(out["err_vs_truth"] <= CLI_F64_LIMIT, "cli smallest float64")


def phase_four(N3=216, N2=256, Ne=512):
    """The sharded drivers on a four-card mesh, each against its reference,
    with the shard placement checked. The limits are checked after all
    three ran, so a failing run still reports every reading."""
    import jax
    import jax.numpy as jnp

    from dune_eigensolver_tpu.dist import (
        make_mesh,
        sharded_generalized_inverse,
        sharded_generalized_inverse_general,
        sharded_lobpcg_generalized,
    )
    from dune_eigensolver_tpu.oracle.analytic import (
        eigenvalues_laplace_dirichlet_3d,
    )
    from dune_eigensolver_tpu.oracle.scipy_oracle import smallest_generalized
    from dune_eigensolver_tpu.sparse import problems
    from dune_eigensolver_tpu.sparse.formats import DIAMatrix

    mesh = make_mesh(4)
    placed = sorted({d.id for d in mesh.devices.flat})
    _check(len(placed) == 4, f"mesh devices {placed}")

    def on_four(res, name):
        ids = {s.device.id for s in res.eigenvectors.addressable_shards}
        _check(len(ids) == 4, f"{name}: eigenvectors on devices {ids}")
        return len(ids)

    t0 = time.perf_counter()
    A = problems.laplacian_dirichlet_3d(N3, dtype=np.float32)
    n = A.shape[0]
    B = DIAMatrix(jnp.ones((1, n), jnp.float32), (0,), A.shape)
    res = sharded_lobpcg_generalized(
        A, B, nev=24, tol=2e-3, maxiter=300, mesh=mesh, precond="mg",
        prec_dtype=jnp.bfloat16, ortho_block=24,
    )
    jax.block_until_ready(res.eigenvalues)
    lam = np.sort(np.asarray(res.eigenvalues, np.float64))[:20]
    err = _rel_max(lam, eigenvalues_laplace_dirichlet_3d(N3, count=20))
    k = on_four(res, "sharded_lobpcg_generalized")
    name = "four: sharded_lobpcg_generalized mg 3d"
    _log(name, t0, n=n, nev=20, iters=int(res.iterations),
         rel_err20=f"{err:.2e}", shards_on=k)
    checks = [(name, err)]
    del A, B, res

    t0 = time.perf_counter()
    A = problems.laplacian_neumann_2d(N2, dtype=np.float32)
    B = problems.laplacian_b_2d(N2, 3, dtype=np.float32)
    ref, _ = smallest_generalized(A, B, 8, sigma=-1e-3)
    res = sharded_generalized_inverse(A, B, nev=8, tol=2e-3, maxiter=200,
                                      shift=1e-3, mesh=mesh,
                                      rayleigh_ritz=True)
    lam = np.asarray(res.eigenvalues, np.float64)
    err = _rel_max(np.sort(lam), ref)
    r = _residuals(A, B, lam, res.eigenvectors)
    k = on_four(res, "sharded_generalized_inverse")
    name = "four: sharded_generalized_inverse geneo"
    _log(name, t0, n=A.shape[0], nev=8, iters=int(res.iterations),
         rel_err=f"{err:.2e}", residual=f"{r:.2e}", shards_on=k)
    checks.append((name, err, r))

    t0 = time.perf_counter()
    A, B = problems.elasticity_2d(Ne, dtype=np.float32)
    ref, _ = smallest_generalized(A, B, 4, sigma=-1e-3)
    res = sharded_generalized_inverse_general(
        A, B, nev=4, tol=2e-3, maxiter=300, shift=1e-3, mesh=mesh,
        rayleigh_ritz=True, cg_rtol=1e-6, cg_maxiter=2000,
    )
    lam = np.asarray(res.eigenvalues, np.float64)
    err = _rel_max(np.sort(lam), ref)
    r = _residuals(A, B, lam, res.eigenvectors)
    k = on_four(res, "sharded_generalized_inverse_general")
    name = "four: sharded_generalized_inverse_general elasticity"
    _log(name, t0, n=A.shape[0], nev=4, iters=int(res.iterations),
         rel_err=f"{err:.2e}", residual=f"{r:.2e}", shards_on=k)
    checks.append((name, err, r))
    for c in checks:
        _check_limits(*c)


def main(argv) -> int:
    global CARD
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX runs on "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1
    from dune_eigensolver_tpu import backend
    from dune_eigensolver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    CARD = backend.card()
    four = "--four" in argv
    if four:
        _check(len(jax.devices()) >= 4, f"--four needs 4 GPUs, "
               f"found {len(jax.devices())}")
        phase_four()
    else:
        for phase in (phase_dia, phase_general, phase_geneo,
                      phase_elasticity, phase_north_star, phase_cli):
            phase()
    dev = backend.device_record()
    print(CARD, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": 4 if four else dev["count"]}}), flush=True)
    return 0


CARD = "not read"

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
