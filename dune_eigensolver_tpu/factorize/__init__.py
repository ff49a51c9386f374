from dune_eigensolver_tpu.factorize.banded import (
    BandedFactorization,
    banded_inverse_factory,
    banded_solve,
    factorize_banded,
    factorize_banded_device,
)
from dune_eigensolver_tpu.factorize.cg import cg_inverse_factory, cg_solve
from dune_eigensolver_tpu.factorize.chebyshev import (
    cheb_cg_inverse_factory,
    chebyshev_apply,
    chebyshev_inverse_factory,
)
from dune_eigensolver_tpu.factorize.host_lu import (
    FactorizedMatrix,
    factorize,
    lu_inverse_factory,
)
from dune_eigensolver_tpu.factorize.multigrid import (
    mg_cg_inverse_factory,
    mg_inverse_factory,
)


def default_inverse_factory(A_int, **kw):
    """Pick the right shift-invert engine for the operand:

    * DIA operators with moderate bandwidth (2D stencils: bw = N = sqrt(n))
      -> block-banded partitioned-inverse factors solved by a scan of dense
      matmuls (factorize.banded) — the on-device direct path;
    * DIA with wide bandwidth (3D stencils: bw = N^2) -> Chebyshev-
      preconditioned Jacobi-CG (factorize.cg + factorize.chebyshev) — band
      storage would be O(n * N^2) there, and 3D direct factorizations fill
      catastrophically in any ordering; the Krylov engines run on the
      guarded SpMM when the operand is a PaddedDIA;
    * other formats -> reverse-Cuthill-McKee bandwidth reduction + the same
      banded engine (factorize.reordered); if RCM cannot confine the band,
      Jacobi-CG.

    Marked ``internal``: solver wrappers hand it the internal (possibly
    guarded PaddedDIA) operand; setup-time engines recover the logical
    operand via ``to_dia``.
    """
    from dune_eigensolver_tpu.factorize.banded import _DEVICE_BW_MAX
    from dune_eigensolver_tpu.factorize.reordered import rcm_banded_inverse_factory
    from dune_eigensolver_tpu.kernels.dia_spmm import PaddedDIA
    from dune_eigensolver_tpu.sparse.formats import DIAMatrix

    if isinstance(A_int, (DIAMatrix, PaddedDIA)):
        bw = max(abs(o) for o in A_int.offsets)
        if bw <= _DEVICE_BW_MAX:
            A_log = A_int.to_dia() if isinstance(A_int, PaddedDIA) else A_int
            return banded_inverse_factory(A_log, **kw)
        # wide band (3D): structured stencil patterns get V-cycle-
        # preconditioned CG (n-independent iteration count); anything else
        # Chebyshev-preconditioned CG — fixed odd-degree polynomial of
        # D^-1 A as the (SPD) preconditioner cuts the dot-bearing outer
        # iterations ~degree-fold
        from dune_eigensolver_tpu.factorize.multigrid import (
            detect_grid_dims,
            mg_cg_inverse_factory,
        )

        if detect_grid_dims(A_int.offsets, A_int.shape[0]) is not None:
            return mg_cg_inverse_factory(rtol=1e-5, maxiter=100)(A_int)
        return cheb_cg_inverse_factory(rtol=1e-5, maxiter=300)(A_int)
    try:
        return rcm_banded_inverse_factory(A_int, **kw)
    except ValueError:
        return cheb_cg_inverse_factory(rtol=1e-5, maxiter=300)(A_int)


default_inverse_factory.internal = True


def solve_linear_system(A, b):
    """Single-RHS sanity solve through the default engine ("just to check if
    it works", umfpacktools.hh:222-223 / :223-265). Returns x with A x = b."""
    import jax.numpy as jnp

    from dune_eigensolver_tpu.solvers.standard import normalize_inverse

    aux, fn = normalize_inverse(default_inverse_factory(A))
    if getattr(fn, "layout_t", False):
        return fn(aux, jnp.asarray(b).reshape(1, -1))[0]
    return fn(aux, jnp.asarray(b).reshape(-1, 1))[:, 0]


__all__ = [
    "solve_linear_system",
    "BandedFactorization",
    "banded_inverse_factory",
    "banded_solve",
    "factorize_banded",
    "factorize_banded_device",
    "cg_inverse_factory",
    "cg_solve",
    "cheb_cg_inverse_factory",
    "chebyshev_apply",
    "chebyshev_inverse_factory",
    "FactorizedMatrix",
    "factorize",
    "lu_inverse_factory",
    "mg_inverse_factory",
    "mg_cg_inverse_factory",
    "default_inverse_factory",
]
