"""Internal solver layout engine: guarded transposed multivectors.

Solver cores iterate on the TRANSPOSED multivector (m, n*) — the analogue of
the reference's contiguous 8-RHS blocks (multivector.hh:130-139). With DIA
operands in the guarded mode the internal width n* is the ``PaddedLayout``
width, so the whole while-loop runs with ZERO marshalling: the SpMM, the
orthonormalization (left m x m transforms preserve the zero guards), the
Rayleigh dots (guards contribute zero) and the Krylov inverse engines all
operate on the same persistent buffers.

``make_engine`` decides the internal representation once per solve:

* DIA operands where ``backend.dia_spmm_mode()`` says 'padded' (or
  ``force_padded`` in tests) -> one ``PaddedLayout`` built from the UNION
  of A'/B offsets, operators pre-padded once (``PaddedDIA``), multivectors
  guarded;
* anything else -> plain transposed arrays, operators as-is (``spmm_t``'s
  XLA formulations).

Inverse factories keep the round-1 column-layout contract ``fn(aux, X(n,m))``
(factorize/banded, host_lu, …); the engine bridges them with a memoized
adapter keyed on the inner fn so solver jit caches stay warm (see CLAUDE.md
architecture invariants). Factories that understand the internal layout mark
their fn with ``fn.layout_t = True`` and skip the adapter (factorize/cg,
factorize/chebyshev — the inner Krylov loops then run the fast SpMM too).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from dune_eigensolver_tpu.kernels.dia_spmm import PaddedDIA, PaddedLayout
from dune_eigensolver_tpu.sparse.formats import DIAMatrix


_SETUP_MEMO: "dict" = {}
_SETUP_MEMO_MAX = 32


def memoized_setup(objs, params, build):
    """Memoize per-solve setup artifacts (internal operands, layouts,
    adapted inverse pairs) on the IDENTITY of the operand containers plus
    the static params.

    Repeated solves on the same operand objects — the GenEO pattern: the
    adaptive driver re-solves per growth round, and production coarse-space
    assembly solves the same pencil many times — otherwise pay the full
    host setup (shift fold, RCM, shard planning, factorization, device
    upload) on every call. Keys use
    ``id(obj)`` guarded by ``weakref`` eviction so a dead operand can never
    alias a new one; objects that do not support weakrefs are NOT cached
    (stale-id aliasing would be unsound). Containers are immutable (frozen
    dataclasses over jax arrays), so identity implies value. LRU-bounded.
    """
    import weakref

    key = tuple(id(o) for o in objs) + tuple(params)
    hit = _SETUP_MEMO.get(key)
    if hit is not None:
        return hit[0]
    val = build()
    refs = []
    try:
        for o in objs:
            refs.append(weakref.ref(o, lambda _r, k=key: _SETUP_MEMO.pop(k, None)))
    except TypeError:
        return val  # unweakrefable operand: skip caching, stay sound
    _SETUP_MEMO[key] = (val, refs)
    while len(_SETUP_MEMO) > _SETUP_MEMO_MAX:
        _SETUP_MEMO.pop(next(iter(_SETUP_MEMO)))
    return val


@dataclasses.dataclass(frozen=True)
class PadAux:
    """Pytree wrapping a column-layout inverse aux with static geometry so
    the memoized adapter can unpad/transpose inside the trace."""

    inner: Any
    guard: int  # static
    n: int  # static


jax.tree_util.register_dataclass(
    PadAux, data_fields=["inner"], meta_fields=["guard", "n"]
)


_ADAPTED_FNS = {}


def adapt_inverse(inv_aux, inv_fn, layout: Optional[PaddedLayout]):
    """Bridge a column-layout ``fn(aux, X(n, m))`` inverse to the internal
    guarded transposed layout. Memoized on the inner fn identity so the
    solver cores' jit caches (keyed on fn identity) hit across solves."""
    if getattr(inv_fn, "layout_t", False):
        return inv_aux, inv_fn  # already internal-native
    key = (id(inv_fn), layout is not None)
    if key not in _ADAPTED_FNS:
        if layout is None:

            def adapted(aux, Xt, _fn=inv_fn):
                return _fn(aux, Xt.T).T

        else:

            def adapted(aux, Xt, _fn=inv_fn):
                G, n = aux.guard, aux.n
                X_log = lax.slice(Xt, (0, G), (Xt.shape[0], G + n)).T
                Y = _fn(aux.inner, X_log).T
                pad_r = Xt.shape[1] - G - n
                return jnp.pad(Y, ((0, 0), (G, pad_r)))

        _ADAPTED_FNS[key] = adapted
    aux = inv_aux if layout is None else PadAux(inv_aux, layout.G, layout.n)
    return aux, _ADAPTED_FNS[key]


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Static description of the internal layout (goes into jit static cfg).

    ``guard``/``n``/``width`` are None for the plain (ungarded) layout.
    """

    guard: Optional[int]
    n: Optional[int]
    width: Optional[int]

    @property
    def padded(self) -> bool:
        return self.guard is not None


def make_engine(
    A_sh,
    B=None,
    m: int = 8,
    force_padded: Optional[bool] = None,
) -> Tuple[Any, Any, Optional[PaddedLayout], EngineSpec]:
    """Pick the internal representation: (A_int, B_int, layout, spec).

    ``force_padded``: True forces the guarded layout, False forces plain;
    None -> guarded iff both operands are DIA and
    ``backend.dia_spmm_mode()`` is 'padded'.
    """
    from dune_eigensolver_tpu import backend

    is_dia = isinstance(A_sh, DIAMatrix) and (B is None or isinstance(B, DIAMatrix))
    if force_padded is None:
        force_padded = backend.dia_spmm_mode() == "padded"
    if not (is_dia and force_padded):
        return A_sh, B, None, EngineSpec(None, None, None)
    union = set(A_sh.offsets)
    if B is not None:
        union |= set(B.offsets)
    L = PaddedLayout(A_sh.shape[0], m, tuple(sorted(union)))
    A_int = L.pad_operator(A_sh)
    B_int = None if B is None else L.pad_operator(B)
    return A_int, B_int, L, EngineSpec(L.G, L.n, L.width)


def to_internal(Qt: jax.Array, layout: Optional[PaddedLayout]) -> jax.Array:
    """(m, n) transposed multivector -> internal (guarded) layout."""
    return Qt if layout is None else layout.pad(Qt)


def from_internal_vectors(
    Qi: jax.Array, spec: EngineSpec, n: int
) -> jax.Array:
    """Internal (m, n*) -> public column layout (n, m). Static slicing only
    (usable inside jitted cores)."""
    if spec.padded:
        Qi = lax.slice(Qi, (0, spec.guard), (Qi.shape[0], spec.guard + spec.n))
    return Qi.T


def guard_vec(v: jax.Array, spec: EngineSpec, fill=0.0) -> jax.Array:
    """(n,) -> internal (n*,) with ``fill`` in the guards (fill=1 for
    inverse-diagonal scalings)."""
    if not spec.padded:
        return v
    out = jnp.full((spec.width,), fill, v.dtype)
    return lax.dynamic_update_slice(out, v, (spec.guard,))
