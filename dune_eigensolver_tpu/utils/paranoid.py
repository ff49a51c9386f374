"""Debug-mode runtime checks: a NaN tripwire on the SpMM kernel outputs
and a check of the ``b_identity`` caller assertion.

A solver loop smears one non-finite kernel output across the whole basis
within an iteration, and the b_identity fast path trusts the caller that B
is the identity. Both failures are silent by default, and both checks cost
device work, so they are opt-in:

    from dune_eigensolver_tpu.utils.paranoid import set_paranoid
    set_paranoid(True)          # or ev.paranoid=1 on the CLI

then every ``spmm_t`` kernel dispatch appends a first-lane-block isfinite
check that prints a loud message from the device the moment non-finite
values appear (``jax.debug.print`` under ``lax.cond`` — works inside jitted
while-loops). Zero cost when disabled: the flag is read at TRACE time, so
hot paths compile without the check. Enabling/disabling does not retrace
already-compiled solves — flip it before building the jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_PARANOID = False


def set_paranoid(on: bool) -> None:
    """Enable/disable the kernel-output NaN tripwire (trace-time flag)."""
    global _PARANOID
    _PARANOID = bool(on)


def paranoid_enabled() -> bool:
    return _PARANOID


def b_identity_check(B, tol: float = 1e-6) -> None:
    """Paranoid-mode verification of the ``b_identity=True`` caller
    assertion: applies B to a RANDOM probe vector ON
    DEVICE and alarms via ``jax.debug.print`` if ``max |B v - v|`` exceeds
    ``tol * max|v|`` — no host fetch, which would stall the dispatch queue
    and is why the assertion is unchecked by default. The probe is
    random, not all-ones: any unit-row-sum matrix (row-stochastic, or
    I + a zero-row-sum perturbation) passes the ones probe while being far
    from the identity (ADVICE r4). Fixed seed keeps the check
    deterministic. One extra SpMM dispatch, paranoid mode only."""
    if not _PARANOID or B is None:
        return
    from dune_eigensolver_tpu.sparse.spmm import spmm

    @jax.jit
    def check(Bop):
        v = jax.random.normal(
            jax.random.PRNGKey(7), (Bop.shape[0], 1), Bop.dtype
        )
        bad = jnp.max(jnp.abs(spmm(Bop, v) - v)) > tol * jnp.max(jnp.abs(v))

        def alarm(_):
            jax.debug.print(
                "PARANOID: b_identity=True but max |B@v - v| on a random "
                "probe exceeds {} * max|v| - the caller's identity "
                "assertion is WRONG and all B-applies are being skipped",
                tol,
            )
            return 0

        lax.cond(bad, alarm, lambda _: 0, 0)
        return 0

    check(B)


def nan_check(Y: jax.Array, tag: str) -> jax.Array:
    """Identity pass-through that, in paranoid mode, alarms on non-finite
    values in a 128-column block of ``Y`` (cheap: all rows of 128 columns,
    not the full array). Returns Y unchanged either way."""
    if not _PARANOID:
        return Y
    ncheck = min(128, Y.shape[-1])
    # sample the array CENTER: guarded layouts keep zeros at the edges, and
    # solver loops smear any NaN across all columns within one ortho anyway
    start = (Y.shape[-1] - ncheck) // 2
    block = lax.slice_in_dim(Y, start, start + ncheck, axis=Y.ndim - 1)
    bad = ~jnp.isfinite(block).all()

    def alarm(_):
        jax.debug.print(
            "PARANOID: non-finite values after kernel '" + tag + "' "
            "(sampled 128-column block)"
        )
        return 0

    lax.cond(bad, alarm, lambda _: 0, 0)
    return Y
