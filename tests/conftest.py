"""Test configuration: CPU backend with 8 virtual devices + f64 enabled.

Multi-device code paths are exercised on a simulated 8-device CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8), the strategy SURVEY.md
§4 prescribes; bench.py and chip_smoke.py run on the GPU instead.
Environment must be set before jax initializes, hence this module-level code.
The DIA SpMM kernel (Pallas, Triton route) runs in interpret mode here.
"""

import os

# unit tests always run on the simulated CPU mesh. Env alone is not enough —
# pytest plugins can import jax before this conftest, and jax reads
# JAX_PLATFORMS only at import — so also force it through jax.config.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

assert jax.default_backend() == "cpu", (
    "tests must run on the simulated CPU mesh, got " + jax.default_backend()
)
assert len(jax.devices()) == 8

from dune_eigensolver_tpu.kernels import dia_spmm  # noqa: E402

dia_spmm.set_interpret(True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(123)
