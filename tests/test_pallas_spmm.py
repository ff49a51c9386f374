"""DIA SpMM kernel (``padded_spmm``, Pallas on the Triton route) vs the XLA
reference, in Pallas interpret mode on the CPU.

Kernel cross-checking by redundancy, the reference's own verification style
(src/dune-eigensolver.cc:186-288 runs naive vs blocked vs SIMD variants on
identical seeded input).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dune_eigensolver_tpu.kernels.dia_spmm import (
    PaddedLayout,
    dia_spmm_t_xla,
    padded_spmm,
)
from dune_eigensolver_tpu.sparse import problems
from dune_eigensolver_tpu.sparse.formats import DIAMatrix
from dune_eigensolver_tpu.sparse.spmm import spmm


def _problem(N=24, m=8, dtype=np.float32):
    A = problems.laplacian_dirichlet_2d(N, dtype=dtype)
    n = A.shape[0]
    Xt = jax.random.normal(jax.random.PRNGKey(3), (m, n), dtype=dtype)
    return A, Xt


def _kernel_t(A, Xt):
    """One padded_spmm application on the (m, n) logical block."""
    m, n = Xt.shape
    L = PaddedLayout(n, m, A.offsets)
    return L.unpad(padded_spmm(L.pad_operator(A), L.pad(Xt)), m)


def test_xla_t_matches_spmm():
    A, Xt = _problem()
    Y1 = dia_spmm_t_xla(A, Xt)
    Y2 = spmm(A, Xt.T).T
    np.testing.assert_allclose(np.asarray(Y1), np.asarray(Y2), rtol=1e-5, atol=1e-5)


def test_pallas_matches_xla_interpret():
    A, Xt = _problem()
    Y1 = _kernel_t(A, Xt)
    Y2 = dia_spmm_t_xla(A, Xt)
    np.testing.assert_allclose(np.asarray(Y1), np.asarray(Y2), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [8, 24])
def test_pallas_padded_matches_xla_interpret(m):
    A, Xt = _problem(m=m)
    n = Xt.shape[1]
    L = PaddedLayout(n, m, A.offsets)
    Yp = padded_spmm(L.pad_operator(A), L.pad(Xt))
    Y2 = dia_spmm_t_xla(A, Xt)
    np.testing.assert_allclose(
        np.asarray(L.unpad(Yp)), np.asarray(Y2), rtol=1e-5, atol=1e-5
    )
    # guards and tail stay zero so applications chain without re-padding
    Yp_np = np.asarray(Yp)
    interior = np.zeros(Yp_np.shape, dtype=bool)
    interior[:m, L.G : L.G + n] = True
    assert np.all(Yp_np[~interior] == 0.0)


def test_padded_operator_persistent():
    # the hot-path API: pad the operator once, chain padded_spmm calls
    A, Xt = _problem(N=16)
    m, n = Xt.shape
    L = PaddedLayout(n, m, A.offsets)
    Ap = L.pad_operator(A)
    Yp = padded_spmm(Ap, L.pad(Xt))
    Zp = padded_spmm(Ap, Yp)
    Z2 = dia_spmm_t_xla(A, dia_spmm_t_xla(A, Xt))
    np.testing.assert_allclose(
        np.asarray(L.unpad(Zp)), np.asarray(Z2), rtol=1e-4, atol=1e-4
    )
    # diagonal helpers
    np.testing.assert_allclose(
        np.asarray(Ap.diagonal()), np.asarray(A.diagonal()), rtol=1e-6
    )
    pd = np.asarray(Ap.padded_diagonal(fill=1.0))
    assert pd.shape == (L.width,)
    np.testing.assert_allclose(pd[L.G : L.G + n], np.asarray(A.diagonal()), rtol=1e-6)
    assert np.all(pd[: L.G] == 1.0) and np.all(pd[L.G + n :] == 1.0)


def test_padded_layout_shared_between_operators():
    # generalized solve: A' and B share one layout built from offset union
    A, Xt = _problem(N=16)
    m, n = Xt.shape
    B = problems.laplacian_b_2d(16, 3, dtype=np.float32)
    union = tuple(sorted(set(A.offsets) | set(B.offsets)))
    L = PaddedLayout(n, m, union)
    Ap, Bp = L.pad_operator(A), L.pad_operator(B)
    Xp = L.pad(Xt)
    for op, ref in ((Ap, A), (Bp, B)):
        Yp = padded_spmm(op, Xp)
        np.testing.assert_allclose(
            np.asarray(L.unpad(Yp)),
            np.asarray(dia_spmm_t_xla(ref, Xt)),
            rtol=1e-5,
            atol=1e-5,
        )


def test_pallas_padded_chains():
    # Y = A (A X): chain two padded applications, compare against XLA twice
    A, Xt = _problem(N=16)
    m, n = Xt.shape
    L = PaddedLayout(n, m, A.offsets)
    Ap = L.pad_operator(A)
    Zp = padded_spmm(Ap, padded_spmm(Ap, L.pad(Xt)))
    Z2 = dia_spmm_t_xla(A, dia_spmm_t_xla(A, Xt))
    np.testing.assert_allclose(
        np.asarray(L.unpad(Zp)), np.asarray(Z2), rtol=1e-4, atol=1e-4
    )


def test_pallas_padded_odd_n():
    # n not a multiple of the column block: the tail must stay inert
    dtype = np.float32
    rng = np.random.default_rng(0)
    n, m = 300, 8
    import scipy.sparse as sp

    from dune_eigensolver_tpu.sparse.formats import dia_from_scipy

    S = sp.diags(
        [rng.standard_normal(n - 2), rng.standard_normal(n), rng.standard_normal(n - 2)],
        [-2, 0, 2],
    ).tocsr()
    A = dia_from_scipy(S, dtype=dtype)
    Xt = jax.random.normal(jax.random.PRNGKey(7), (m, n), dtype=dtype)
    np.testing.assert_allclose(
        np.asarray(_kernel_t(A, Xt)), np.asarray(dia_spmm_t_xla(A, Xt)),
        rtol=1e-4, atol=1e-4,
    )


def test_pallas_grouped_matches_xla_2d():
    # 2D band: offsets {-N, -1, 0, 1, N} reach across several column blocks
    A, Xt = _problem(N=40)
    np.testing.assert_allclose(
        np.asarray(_kernel_t(A, Xt)), np.asarray(dia_spmm_t_xla(A, Xt)),
        rtol=1e-5, atol=1e-5,
    )


def test_pallas_grouped_matches_xla_3d():
    # wide-band 3D stencil: offsets {-N^2}, {-N..N}, {+N^2}
    N, m = 8, 8
    A = problems.laplacian_dirichlet_3d(N, dtype=np.float32)
    n = A.shape[0]
    Xt = jax.random.normal(jax.random.PRNGKey(5), (m, n), dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(_kernel_t(A, Xt)), np.asarray(dia_spmm_t_xla(A, Xt)),
        rtol=1e-5, atol=1e-5,
    )


def test_pallas_grouped_odd_sizes():
    N, m = 7, 8  # n = 343, not block-aligned
    A = problems.laplacian_dirichlet_3d(N, dtype=np.float32)
    n = A.shape[0]
    Xt = jax.random.normal(jax.random.PRNGKey(6), (m, n), dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(_kernel_t(A, Xt)), np.asarray(dia_spmm_t_xla(A, Xt)),
        rtol=1e-4, atol=1e-4,
    )


@pytest.mark.parametrize("m", [1, 5, 20])
def test_pallas_rows_not_multiple_of_8(m):
    # the kernel masks the last row chunk: any m works, LOBPCG's 3m included
    A, Xt = _problem(N=12, m=m)
    np.testing.assert_allclose(
        np.asarray(_kernel_t(A, Xt)), np.asarray(dia_spmm_t_xla(A, Xt)),
        rtol=1e-5, atol=1e-5,
    )


def test_pallas_bf16_accumulates_in_f32():
    # bf16 storage, f32 accumulation: agrees with the f32 product of the
    # same bf16-rounded inputs to bf16 output rounding
    A, Xt = _problem(N=16)
    A16 = DIAMatrix(A.data.astype(jnp.bfloat16), A.offsets, A.shape)
    X16 = Xt.astype(jnp.bfloat16)
    Y = _kernel_t(A16, X16)
    assert Y.dtype == jnp.bfloat16
    A32 = DIAMatrix(A16.data.astype(jnp.float32), A.offsets, A.shape)
    ref = np.asarray(dia_spmm_t_xla(A32, X16.astype(jnp.float32)))
    err = np.abs(np.asarray(Y, np.float32) - ref).max()
    assert err <= 2e-2 * np.abs(ref).max()


def test_pallas_f64_keeps_f64():
    A, Xt = _problem(N=12, dtype=np.float64)
    Y = _kernel_t(A, Xt)
    assert Y.dtype == jnp.float64
    np.testing.assert_allclose(
        np.asarray(Y), np.asarray(dia_spmm_t_xla(A, Xt)), rtol=1e-13,
        atol=1e-13,
    )


def test_padded_layout_geometry():
    # the guard covers the widest offset on 128-column boundaries
    L = PaddedLayout(1000, 8, (-300, -1, 0, 1, 300))
    assert L.G >= 300 and L.G % 128 == 0
    assert L.width >= 1000 + 2 * L.G and L.width % 128 == 0
    # an operator wider than the layout's guard is refused
    wide = DIAMatrix(jnp.zeros((1, 256), jnp.float32), (200,), (256, 256))
    with pytest.raises(ValueError, match="guard"):
        PaddedLayout(256, 8, (0,)).pad_operator(wide)
