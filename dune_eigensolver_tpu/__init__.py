"""dune_eigensolver_tpu — a sparse eigensolver framework in JAX.

A JAX/XLA/Pallas implementation with the capabilities of the
reference C++ DUNE module ``normallytangent/dune-eigensolver``:

* tall-skinny multivector operations (blocked orthonormalization, blocked
  B-orthonormalization with loss-of-orthogonality monitor, per-column dots)
  — reference: dune/eigensolver/kernels_cpp.hh
* sparse matrix containers (DIA / ELL / CSR / BSR) with tall-skinny SpMM
  — reference: kernels_cpp.hh:596-657 (matmul_sparse_tallskinny_*)
* three solver entry points: ``standard_largest``, ``standard_inverse``,
  ``generalized_inverse`` — reference: dune/eigensolver/eigensolver.hh:28,116,204
* host-factorized sparse LU externalized to device arrays + multi-RHS
  triangular solve — reference: dune/eigensolver/umfpacktools.hh,
  kernels_cpp.hh:660-755
* oracle validation against scipy.sparse.linalg and analytic Laplacian
  spectra — reference: arpack_geneo_wrapper.hh, src/dune-eigensolver.cc:437-446
* beyond the reference: row-partitioned multi-device execution over a
  ``jax.sharding.Mesh`` with halo exchange + allreduce orthogonalization.

The compute path is JAX/XLA with a Pallas kernel for the DIA SpMM; host-side
setup (format conversion, level scheduling, partitioning) has a native C++
fast path (see ``native/``).
"""

from dune_eigensolver_tpu.sparse.formats import (
    DIAMatrix,
    ELLMatrix,
    BSRMatrix,
    dia_from_scipy,
    ell_from_scipy,
    bsr_from_scipy,
)
from dune_eigensolver_tpu.sparse.spmm import spmm
from dune_eigensolver_tpu.sparse import problems
from dune_eigensolver_tpu.ops.ortho import (
    orthonormalize_blocked,
    b_orthonormalize_blocked,
    dot_products_diagonal,
    dot_products_all,
)
from dune_eigensolver_tpu.solvers.standard import standard_largest, standard_inverse
from dune_eigensolver_tpu.solvers.generalized import generalized_inverse
from dune_eigensolver_tpu.solvers.result import EigenResult

__version__ = "0.1.0"

__all__ = [
    "DIAMatrix",
    "ELLMatrix",
    "BSRMatrix",
    "dia_from_scipy",
    "ell_from_scipy",
    "bsr_from_scipy",
    "spmm",
    "problems",
    "orthonormalize_blocked",
    "b_orthonormalize_blocked",
    "dot_products_diagonal",
    "dot_products_all",
    "standard_largest",
    "standard_inverse",
    "generalized_inverse",
    "EigenResult",
]
