"""The one place the program reads which device JAX runs on.

``platform()`` is ``jax.default_backend()``: 'gpu' on the card, 'cpu' on the
simulated test mesh. Everything that depends on the device asks here, and
nothing guesses: there is no exception handler and no default that hides
the device.

``dia_spmm_mode()`` chooses the DIA SpMM formulation the solvers iterate:
'padded' (operators and multivectors in the persistent zero-guarded layout,
applied by the Pallas kernel ``kernels.dia_spmm.padded_spmm``) or 'xla'
(plain shifted slices, ``kernels.dia_spmm.dia_spmm_t_xla``). The choice is
a measured property of the card, recorded in PERF.md.
"""

from __future__ import annotations

import subprocess

import jax


def platform() -> str:
    return jax.default_backend()


def dia_spmm_mode() -> str:
    """'padded' on the GPU, where the kernel beat XLA end to end; 'xla'
    elsewhere (the CPU test mesh, where the kernel runs only in the Pallas
    interpreter)."""
    return "padded" if platform() == "gpu" else "xla"


def card() -> str:
    """The first card's name and power limit as nvidia-smi reports them
    (``name, power.limit``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_record() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}
