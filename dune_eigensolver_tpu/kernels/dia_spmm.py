"""Tall-skinny DIA SpMM on the persistent zero-guarded layout.

The hot operation of the stencil solvers — the counterpart of the
reference's ``matmul_sparse_tallskinny_{blocked,avx2_b8,neon_b8}``
(kernels_cpp.hh:626, kernels_avx2.hh:1021, kernels_neon.hh:1314). The
multivector is stored *transposed* as (m, n), so each diagonal contributes
one constant-offset slice of X times a per-column coefficient row.

* the multivector lives persistently in a zero-guarded buffer
  (``PaddedLayout``): logical column i at buffer column i + G, zeros in the
  guards. Chained applications Y = A X, X = A Y, ... never re-pad; the
  output guards are written as zeros, so the invariant holds across a
  solver loop.
* the operator is pre-padded ONCE into the same geometry (``PaddedDIA``).
* ``padded_spmm`` is a Pallas kernel on the Triton route: one program per
  column tile loads each coefficient once for all m rows and reads the
  shifted X columns through masked loads; the reuse of neighbouring X
  columns across diagonals is served by the GPU's caches. PERF.md gives
  its times on the card beside XLA's fusion of the same computation.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from dune_eigensolver_tpu.sparse.formats import DIAMatrix


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def dia_spmm_t_xla(A: DIAMatrix, Xt: jax.Array) -> jax.Array:
    """XLA reference for the transposed layout: Yt = (A @ Xt.T).T, Xt (m, n)."""
    m, n = Xt.shape
    halo = max((abs(o) for o in A.offsets), default=0)
    Xp = jnp.pad(Xt, ((0, 0), (halo, halo)))
    acc = jnp.zeros_like(Xt)
    for d, off in enumerate(A.offsets):
        acc = acc + A.data[d][None, :] * lax.slice(
            Xp, (0, halo + off), (m, halo + off + n)
        )
    return acc


class PaddedLayout:
    """Static geometry of the persistent zero-guarded transposed multivector.

    Logical column i of an (m, n) multivector lives at buffer column i + G;
    the guards [0, G) and [G + n, width) hold zeros. G covers the largest
    halo (rounded up to a 128-column boundary), so every shifted read of an
    interior column stays inside the buffer.

    Build the layout from the UNION of all operator offsets that will share
    it (e.g. A' and B of a generalized solve): ``guard`` must cover the
    largest halo.
    """

    def __init__(self, n: int, m: int, offsets):
        halo = max((abs(o) for o in offsets), default=0)
        G = _round_up(max(halo, 1), 128)
        self.n, self.m = n, m
        self.G = G
        self.halo = halo
        self.width = _round_up(n, 128) + 2 * G

    def pad(self, Xt: jax.Array) -> jax.Array:
        """(m, n) -> guarded (m, width); m may differ from the layout's m
        (e.g. LOBPCG's 3m search blocks share the layout)."""
        m, n = Xt.shape
        if n != self.n:
            raise ValueError(f"pad: Xt has n={n}, layout n={self.n}")
        return jnp.pad(Xt, ((0, 0), (self.G, self.width - n - self.G)))

    def unpad(self, Xp: jax.Array, m: Optional[int] = None) -> jax.Array:
        """guarded (m', width) -> (m, n)."""
        m = self.m if m is None else m
        return Xp[:m, self.G : self.G + self.n]

    def pad_vec(self, v: jax.Array, fill=0.0) -> jax.Array:
        """(n,) -> (width,) with ``fill`` in the guards (fill=1 for inverse
        diagonals so guarded elementwise divisions stay finite)."""
        out = jnp.full((self.width,), fill, v.dtype)
        return lax.dynamic_update_slice(out, v, (self.G,))

    def pad_operator(self, A: DIAMatrix) -> "PaddedDIA":
        """Pre-pad the operator's diagonal data into this geometry (do this
        ONCE at setup; the padded data is what iterates)."""
        halo = max((abs(o) for o in A.offsets), default=0)
        if self.G < halo:
            raise ValueError(
                f"layout guard {self.G} too small for operator halo {halo}; "
                "build the PaddedLayout from the union of operator offsets"
            )
        if A.shape[0] != self.n:
            raise ValueError(f"pad_operator: A n={A.shape[0]}, layout n={self.n}")
        data = jnp.pad(A.data, ((0, 0), (self.G, self.width - self.n - self.G)))
        return PaddedDIA(data=data, offsets=A.offsets, shape=A.shape, guard=self.G)


@dataclasses.dataclass(frozen=True)
class PaddedDIA:
    """A DIA operator pre-padded into a PaddedLayout geometry.

    ``data[d]`` has the logical diagonal at columns [guard, guard + n) and
    zeros elsewhere.
    """

    data: jax.Array  # (ndiag, width)
    offsets: Tuple[int, ...]  # static
    shape: Tuple[int, int]  # static, logical
    guard: int  # static G

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        n = self.shape[0]
        return int(sum(n - abs(o) for o in self.offsets))

    def diagonal(self) -> jax.Array:
        """Logical (n,) main diagonal."""
        d = self.offsets.index(0)
        return lax.dynamic_slice(self.data[d], (self.guard,), (self.n,))

    def padded_diagonal(self, fill=1.0) -> jax.Array:
        """(width,) main diagonal with ``fill`` in the guards (for Jacobi
        scalings applied directly to guarded multivectors)."""
        d = self.offsets.index(0)
        i = lax.iota(jnp.int32, self.data.shape[1])
        inside = (i >= self.guard) & (i < self.guard + self.n)
        return jnp.where(inside, self.data[d], jnp.asarray(fill, self.dtype))

    def to_dia(self) -> DIAMatrix:
        """Recover the logical DIAMatrix (a slice view; used by setup-time
        code — factorizations, scipy bridges — not by hot loops)."""
        return DIAMatrix(
            data=lax.dynamic_slice(
                self.data, (0, self.guard), (self.data.shape[0], self.n)
            ),
            offsets=self.offsets,
            shape=self.shape,
        )


jax.tree_util.register_dataclass(
    PaddedDIA,
    data_fields=["data"],
    meta_fields=["offsets", "shape", "guard"],
)


# Pallas interpret mode for ``padded_spmm``. The kernel compiles only for
# the GPU; the CPU test suite asks for the interpreter explicitly
# (tests/conftest.py calls set_interpret(True)). Nothing derives it from
# the platform.
_INTERPRET = False


def set_interpret(on: bool) -> bool:
    """Set interpret mode for ``padded_spmm``; returns the previous setting."""
    global _INTERPRET
    prev, _INTERPRET = _INTERPRET, bool(on)
    return prev


def _kernel(offsets, m, BT, RB, width, data_ref, x_ref, o_ref):
    # One program per BT-column tile; all m rows in RB-row chunks, so each
    # coefficient is loaded once and used m times. Shifted X loads are
    # masked at the buffer edges (the guard coefficients there are zero).
    # Nothing is carried between programs and the output does not alias
    # the input, so programs may run in any order.
    acc_t = jnp.promote_types(o_ref.dtype, jnp.float32)
    j = pl.program_id(0)
    cols = j * BT + jnp.arange(BT)
    inside = cols < width
    coefs = [
        plgpu.load(data_ref.at[d, cols], mask=inside, other=0.0).astype(acc_t)
        for d in range(len(offsets))
    ]
    for r0 in range(0, m, RB):
        rows = r0 + jnp.arange(RB)
        rmask = rows[:, None] < m
        acc = jnp.zeros((RB, BT), acc_t)
        for d, off in enumerate(offsets):
            c = cols + off
            ok = ((c >= 0) & (c < width))[None, :] & rmask
            xs = plgpu.load(
                x_ref.at[rows[:, None], c[None, :]], mask=ok, other=0.0
            )
            acc = acc + coefs[d][None, :] * xs.astype(acc_t)
        plgpu.store(
            o_ref.at[rows[:, None], cols[None, :]],
            acc.astype(o_ref.dtype),
            mask=inside[None, :] & rmask,
        )


def padded_spmm(Ap: PaddedDIA, Xp: jax.Array) -> jax.Array:
    """Yp = (A @ X) in the persistent guarded layout: Xp/Yp (m, width) with
    zero guards (see PaddedLayout). A Pallas kernel on the Triton route;
    products accumulate in at least float32 whatever the storage dtype.

    Each program covers 2 KiB of every row (512 float32 columns, 1024
    bfloat16: the faster tile of each on the H100, PERF.md), 8 rows at a
    time.
    """
    if Xp.shape[1] != Ap.data.shape[1]:
        raise ValueError(
            f"padded_spmm: X width {Xp.shape[1]} != operator width "
            f"{Ap.data.shape[1]}"
        )
    m, width = Xp.shape
    block_cols = 2048 // jnp.dtype(Xp.dtype).itemsize
    kernel = functools.partial(
        _kernel, tuple(Ap.offsets), m, block_cols, 8, width
    )
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(Xp.shape, Xp.dtype),
        grid=(pl.cdiv(width, block_cols),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=_INTERPRET,
        name="dia_spmm",
    )(Ap.data, Xp)
