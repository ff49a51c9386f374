"""General-sparsity distributed solve example: an unstructured operator
(any scipy CSR — the reference's native BCRS class, kernels_cpp.hh:626-657)
row-sharded over the device mesh through the per-shard ELL SpMM,
with prebuilt-plan reuse for repeated solves.

Run (any machine; uses however many devices JAX sees — set
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu for a
simulated mesh):

    python examples/general_dist_example.py [n] [ndev]
"""

import sys
import time

import numpy as np

from dune_eigensolver_tpu.dist import (
    make_mesh,
    sharded_generalized_inverse_general,
    sharded_standard_largest_general,
    windowed_shard_plan,
)
from dune_eigensolver_tpu.dist.windowed import largest_operator
from dune_eigensolver_tpu.sparse import problems
from dune_eigensolver_tpu.sparse.reorder import rcm_pencil


def main():
    import jax
    import scipy.sparse as sp

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20000
    ndev = int(sys.argv[2]) if len(sys.argv) > 2 else len(jax.devices())

    # an unstructured graph Laplacian; RCM bounds the bandwidth so each
    # shard's SpMM needs only neighbor halos
    S = problems.unstructured_laplacian(
        n, extra_edges=n // 20, seed=5, fmt="scipy"
    )
    A, _, _ = rcm_pencil(S, dtype=np.float32)
    Sr = A.to_scipy().astype(np.float32)
    mesh = make_mesh(ndev)
    print(f"n={n} nnz={Sr.nnz} mesh={ndev} devices")

    # prebuild the plan once: repeated solves skip host re-planning and
    # device re-upload (plan arrays become device-resident on first use)
    plan = windowed_shard_plan(largest_operator(Sr), ndev)
    for i in range(3):
        t0 = time.perf_counter()
        res = sharded_standard_largest_general(
            Sr, nev=4, tol=1e-8, maxiter=300, mesh=mesh, plan=plan
        )
        ev = np.asarray(res.eigenvalues)
        print(
            f"largest solve {i}: {time.perf_counter() - t0:.2f}s "
            f"iters={int(res.iterations)} evals={ev}"
        )

    # generalized shift-invert with the Schwarz per-shard banded inner
    B = sp.eye(n, dtype=np.float32, format="csr")
    t0 = time.perf_counter()
    res = sharded_generalized_inverse_general(
        Sr, B, nev=4, tol=1e-5, maxiter=100, shift=1e-3, mesh=mesh,
        inner="schwarz", cg_rtol=1e-6, cg_maxiter=200,
    )
    print(
        f"generalized[schwarz]: {time.perf_counter() - t0:.2f}s "
        f"iters={int(res.iterations)} "
        f"evals={np.sort(np.asarray(res.eigenvalues))[:4]}"
    )


if __name__ == "__main__":
    main()
