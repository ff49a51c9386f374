"""North-star recipe accuracy envelope (VERDICT r3 ask #8).

The 10M-dof flagship solve (chip_smoke.py phase 6; BASELINE.md) runs an
exact recipe — LOBPCG on the reciprocal pencil, one geometric-multigrid
V(1,1) cycle with bf16 fine smoothing as preconditioner, single-pass
CholeskyQR in 24-row blocks, identity-B fast path, nev=24 guard block. Its
validity was once only prose in the benchmark; these tests pin the recipe's
accuracy envelope at CPU scale (N=24 3D grid) so a silent regression in the
MG coefficient sampling, the blocked ortho, or the b_identity path fails the
suite instead of quietly moving a benchmark field.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dune_eigensolver_tpu.factorize import mg_inverse_factory
from dune_eigensolver_tpu.oracle.analytic import (
    eigenvalues_laplace_dirichlet_3d,
)
from dune_eigensolver_tpu.solvers import lobpcg_generalized
from dune_eigensolver_tpu.sparse import problems
from dune_eigensolver_tpu.sparse.formats import DIAMatrix


def _recipe(N=24, nev=20, nguard=24, **over):
    """The EXACT chip_smoke.py / bench.py north-star call, small-N."""
    dtype = np.float32
    A = problems.laplacian_dirichlet_3d(N, dtype=dtype)
    n = A.shape[0]
    B = DIAMatrix(data=jnp.ones((1, n), dtype), offsets=(0,), shape=A.shape)
    kw = dict(
        nev=nguard, tol=2e-3, maxiter=300, shift=0.0,
        precond=mg_inverse_factory(nu1=1, nu2=1, dtype=jnp.bfloat16),
        min_iter=3, ortho_iterations=1, ortho_block=24, b_identity=True,
    )
    kw.update(over)
    return A, B, lobpcg_generalized(A, B, **kw)


def test_north_star_recipe_accuracy_envelope():
    N, nev = 24, 20
    _, _, res = _recipe(N=N, nev=nev)
    ev = np.sort(np.asarray(res.eigenvalues))[:nev]
    exact = eigenvalues_laplace_dirichlet_3d(N, count=nev)
    err = np.abs(ev - exact).max()
    # at N=216 the nested recipe lands near 1e-6 on the GPU (PERF.md); this
    # single-level N=24 grid lands at ~7.5e-5 under the same tol=2e-3
    # change-based stopping rule (evs are ~4x larger). A broken MG/ortho/b_identity path degrades by orders of
    # magnitude, so 3e-4 is a tight tripwire with headroom for seed noise.
    assert err < 3e-4, (err, ev[:4], exact[:4])
    assert bool(res.converged)
    assert np.isfinite(ev).all()


def test_north_star_b_identity_matches_explicit_b():
    """b_identity=True must agree with the honest B-apply to roundoff —
    the unchecked caller assertion of VERDICT r3 Weak #7, checked."""
    N, nev = 16, 8
    _, _, res_fast = _recipe(N=N, nev=nev, nguard=8, ortho_block=8)
    _, _, res_ref = _recipe(
        N=N, nev=nev, nguard=8, ortho_block=8, b_identity=False
    )
    ev_f = np.sort(np.asarray(res_fast.eigenvalues))
    ev_r = np.sort(np.asarray(res_ref.eigenvalues))
    np.testing.assert_allclose(ev_f, ev_r, rtol=1e-4, atol=1e-7)


def test_north_star_full_ortho_stays_excluded():
    """ortho_block='full' is OUTSIDE the validated envelope (cond(S)^2
    overflows f32 at production n). Guard that the recipe constant stays
    a block sweep in both scripts that run it: if someone flips it to
    'full', this test is the tripwire they must consciously update
    alongside a fresh validation on the card."""
    import os
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for script in ("bench.py", "chip_smoke.py"):
        with open(os.path.join(root, script)) as fh:
            src = fh.read()
        m = re.search(r"ortho_block=([^,\)]+)[,\)]", src)
        assert m is not None, f"{script} north-star recipe lost its ortho_block"
        assert m.group(1).strip() != "'full'", (
            f"{script} north-star recipe must not use ortho_block='full' "
            "(NaNs in f32 at production n) without re-validating on the card"
        )


def test_paranoid_b_identity_check(capfd):
    """ev.paranoid-style opt-in verification of the b_identity assertion
    (VERDICT r3 Weak #7): a wrong assertion alarms from the device; a
    correct one stays silent."""
    from dune_eigensolver_tpu.solvers import lobpcg_generalized
    from dune_eigensolver_tpu.utils.paranoid import set_paranoid

    A = problems.laplacian_dirichlet_2d(12, dtype=np.float32)
    n = A.shape[0]
    B_id = DIAMatrix(
        data=jnp.ones((1, n), np.float32), offsets=(0,), shape=A.shape
    )
    B_mass = problems.laplacian_b_2d(12, 3, dtype=np.float32)
    kw = dict(nev=4, tol=1e-3, maxiter=8, shift=1e-3, b_identity=True,
              precond=False)
    set_paranoid(True)
    try:
        capfd.readouterr()
        lobpcg_generalized(A, B_id, **kw)
        assert "PARANOID" not in capfd.readouterr().out
        lobpcg_generalized(A, B_mass, **kw)
        import jax

        jax.effects_barrier()
        assert "PARANOID" in capfd.readouterr().out
    finally:
        set_paranoid(False)
