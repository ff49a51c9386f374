"""Device timing for the benchmarks.

``bench_loop`` chains K applications of a step inside ONE jit
(``lax.fori_loop``), runs it once to compile and warm up, then takes the
best of ``reps`` timed runs, each ended by ``block_until_ready``. This
mirrors the reference's timing of n_iter kernel repetitions inside one
region (src/dune-eigensolver.cc:199-203) on an asynchronous device.
"""

from __future__ import annotations

import time

import jax
from jax import lax


def bench_loop(step, x0, K: int = 20, reps: int = 5, op_args=()):
    """Best time per application of ``step`` (seconds).

    ``step(x, *op_args) -> x_next`` must be self-composable (same shape in
    and out). ``op_args`` (matrix containers, factorizations) are jit
    arguments, so the compiled program does not embed them as constants.
    """
    f = jax.jit(lambda x, *a: lax.fori_loop(0, K, lambda i, s: step(s, *a), x))
    jax.block_until_ready(f(x0, *op_args))  # compile + warm-up
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x0, *op_args))
        best = min(best, time.perf_counter() - t0)
    return best / K
