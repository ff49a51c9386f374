"""SpMM benchmark on the GPU — one JSON line per measurement on stdout.

Every line carries the card (name and power limit as nvidia-smi reports
them) and the device as JAX reports it, and every number on it was measured
in this run. Each kernel time is set beside a copy of the same byte count
timed in the same run, and beside the card's published peak bandwidth.

Cells:

* DIA SpMM (the stencil solvers' hot operation): 2D 5-point Laplacian at
  n = 4,194,304, m = 8, in float32 and bfloat16; 3D 7-point Laplacian at
  N = 216 (n = 10,077,696), m = 24 and m = 72 (LOBPCG's 3m search block).
  ``kernel``: ``padded_spmm`` on the guarded layout (the Pallas kernel the
  solvers iterate on the GPU); ``xla``: ``dia_spmm_t_xla`` on unguarded
  arrays.
* General SpMM (the elasticity pencil, ``elasticity_2d(512)``,
  n = 522,242): ``bsr_spmm_t`` at m = 8 and m = 128, and ``ell_spmm_t`` on
  its scalar expansion at m = 8.

Bytes are the speed-of-light traffic model: operator data (and indices)
once, X once, Y once. flops = 2 * m * nnz (src/dune-eigensolver.cc:353-373).

* North star end to end (``northstar_kernel``, ``northstar_xla``):
  smallest 20 eigenpairs of the N = 216 3D Laplacian through
  ``lobpcg_nested`` (the chip_smoke.py recipe), on the guarded layout with
  the kernel or on plain arrays with the XLA SpMM; the first call's
  seconds (setup and compilation included) and five steady-state calls.
  Give each variant its own process, with no compile cache, and alternate
  them (kernel, xla, xla, kernel): in one process the second variant's
  first call would reuse what the first compiled.

Usage: ``python bench.py [dia] [general] [northstar_kernel | northstar_xla]``
(default: dia and general). Exits non-zero when JAX finds no GPU or any
cell fails.
"""

import json
import sys

import numpy as np

import jax
import jax.numpy as jnp

from dune_eigensolver_tpu import backend
from dune_eigensolver_tpu.bench.timing import bench_loop

# published peak device-memory bandwidth, keyed by device_kind (NVIDIA
# H100 SXM data sheet). A card not in the table is an error.
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def _emit(rec: dict):
    rec = dict(rec, card=_CARD, device=_DEVICE)
    print(json.dumps(rec), flush=True)


def _copy_time(nbytes: int, dtype) -> float:
    """Seconds for a read+write of ``nbytes`` in total (v -> v + 1)."""
    n = max(1, nbytes // (2 * np.dtype(dtype).itemsize))
    buf = jnp.ones((n,), dtype)
    return bench_loop(lambda v: v + jnp.asarray(1, dtype), buf, K=20)


def _rates(name, t, nbytes, flops, copy_dtype, **extra):
    t_copy = _copy_time(nbytes, copy_dtype)
    _emit(dict(
        cell=name, seconds=t, bytes=nbytes, gb_per_s=nbytes / t / 1e9,
        gflop_per_s=flops / t / 1e9, copy_seconds=t_copy,
        vs_copy=t_copy / t, vs_peak=nbytes / t / _PEAK, **extra,
    ))


DIA_CELLS = [
    ("dia2d", 2048, 8, jnp.float32),
    ("dia2d", 2048, 8, jnp.bfloat16),
    ("dia3d", 216, 24, jnp.float32),
    ("dia3d", 216, 72, jnp.float32),
]


def bench_dia(cells=DIA_CELLS):
    from dune_eigensolver_tpu.kernels.dia_spmm import (
        PaddedDIA,
        PaddedLayout,
        dia_spmm_t_xla,
        padded_spmm,
    )
    from dune_eigensolver_tpu.sparse import problems
    from dune_eigensolver_tpu.sparse.formats import DIAMatrix

    for kind, N, m, dtype in cells:
        if kind == "dia2d":
            A = problems.laplacian_dirichlet_2d(N, dtype=np.float32)
            scale = 8.0
        else:
            A = problems.laplacian_dirichlet_3d(N, dtype=np.float32)
            scale = 12.0
        # scaled to spectral radius < 1 so chained applications stay bounded
        A = DIAMatrix(data=(A.data / scale).astype(dtype), offsets=A.offsets,
                      shape=A.shape)
        n, nd = A.shape[0], len(A.offsets)
        isz = np.dtype(dtype).itemsize
        nbytes = (nd * n + 2 * m * n) * isz
        flops = 2 * m * A.nnz
        Xt = jax.random.normal(jax.random.PRNGKey(0), (m, n), dtype)
        L = PaddedLayout(n, m, A.offsets)
        Ap, Xp = L.pad_operator(A), L.pad(Xt)
        tag = dict(n=n, m=m, dtype=jnp.dtype(dtype).name)

        def padded_step(x, data, _A=Ap):
            return padded_spmm(PaddedDIA(data, _A.offsets, _A.shape, _A.guard), x)

        t = bench_loop(padded_step, Xp, op_args=(Ap.data,))
        _rates(f"{kind}_kernel", t, nbytes, flops, dtype, **tag)

        def plain_step(x, data, _A=A):
            return dia_spmm_t_xla(DIAMatrix(data, _A.offsets, _A.shape), x)

        t = bench_loop(plain_step, Xt, op_args=(A.data,))
        _rates(f"{kind}_xla", t, nbytes, flops, dtype, **tag)
        del A, Ap, Xp, Xt


def bench_general(N=512):
    from dune_eigensolver_tpu.sparse import problems
    from dune_eigensolver_tpu.sparse.formats import bsr_from_scipy, ell_from_scipy
    from dune_eigensolver_tpu.sparse.spmm import bsr_spmm_t, ell_spmm_t

    Ab, _ = problems.elasticity_2d(N, dtype=np.float32)
    S = Ab.to_scipy()
    S = S / float(np.abs(S).sum(axis=1).max())  # bounded chains
    Ab = bsr_from_scipy(S, block=Ab.block, dtype=np.float32)
    Ae = ell_from_scipy(S, dtype=np.float32)
    n = Ab.shape[0]
    cells = [("bsr", Ab, bsr_spmm_t, 8), ("bsr", Ab, bsr_spmm_t, 128),
             ("ell", Ae, ell_spmm_t, 8), ("ell", Ae, ell_spmm_t, 128)]
    for name, M, fn, m in cells:
        if name == "bsr":
            op_bytes = M.bdata.size * 4 + M.bcols.size * 4
        else:
            op_bytes = M.data.size * 4 + M.cols.size * 4
        nbytes = op_bytes + 2 * m * n * 4
        Xt = jax.random.normal(jax.random.PRNGKey(1), (m, n), jnp.float32)
        t = bench_loop(lambda x, op, _f=fn: _f(op, x), Xt, op_args=(M,))
        _rates(f"{name}_spmm", t, nbytes, 2 * m * M.nnz, jnp.float32,
               n=n, m=m, nnz=int(M.nnz), dtype="float32")


def bench_northstar(padded: bool, N=216, samples=5):
    import time

    from dune_eigensolver_tpu.factorize import mg_inverse_factory
    from dune_eigensolver_tpu.oracle.analytic import (
        eigenvalues_laplace_dirichlet_3d,
    )
    from dune_eigensolver_tpu.solvers import lobpcg_nested
    from dune_eigensolver_tpu.sparse import problems
    from dune_eigensolver_tpu.sparse.formats import DIAMatrix

    A = problems.laplacian_dirichlet_3d(N, dtype=np.float32)
    n = A.shape[0]
    B = DIAMatrix(jnp.ones((1, n), jnp.float32), (0,), A.shape)
    exact = eigenvalues_laplace_dirichlet_3d(N, count=20)
    prec = mg_inverse_factory(nu1=1, nu2=1, dtype=jnp.bfloat16)

    def run():
        res = lobpcg_nested(
            A, B, nev=24, tol=2e-3, maxiter=300, shift=0.0,
            min_coarse=48, coarse_tol=2e-4, precond=prec,
            ortho_iterations=1, ortho_block=24, b_identity=True,
            force_padded=padded,
        )
        jax.block_until_ready(res.eigenvalues)
        return res

    t0 = time.perf_counter()
    run()
    t_first = time.perf_counter() - t0
    steady = []
    for _ in range(samples):
        t0 = time.perf_counter()
        res = run()
        steady.append(time.perf_counter() - t0)
    err = float(np.abs(np.sort(np.asarray(res.eigenvalues))[:20]
                       - exact).max())
    _emit(dict(cell="northstar_" + ("kernel" if padded else "xla"),
               seconds=float(np.median(steady)), steady_seconds=steady,
               first_call_seconds=t_first, max_err20=err,
               iterations=int(res.iterations), n=n))


def main(argv):
    global _CARD, _DEVICE, _PEAK
    if backend.platform() != "gpu":
        print(f"bench.py needs a GPU; JAX runs on {backend.platform()!r}",
              file=sys.stderr)
        return 1
    _CARD, _DEVICE = backend.card(), backend.device_record()
    _PEAK = PEAK_BYTES_PER_S[_DEVICE["kind"]]
    phases = argv or ["dia", "general"]
    cells = {"dia": bench_dia, "general": bench_general,
             "northstar_kernel": lambda: bench_northstar(True),
             "northstar_xla": lambda: bench_northstar(False)}
    for p in phases:
        cells[p]()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
