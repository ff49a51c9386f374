"""Checkpoint/resume for long eigensolver runs.

The reference has no checkpointing ("runs are short; restart = rerun with
same seed", SURVEY.md §5). At production scale a shift-invert run over a
10M-dof operator is minutes-to-hours, so this framework adds segmented
execution: the solver runs ``checkpoint_every`` iterations per segment (one
XLA computation each), persists the iterate block Q and Rayleigh quotients
to ``<path>`` after every segment, and resumes from the newest checkpoint on
restart. Subspace iteration restarts cleanly from any iterate block — Q is
the entire algorithmic state (plus the iteration counter for min_iter
bookkeeping).
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional

import numpy as np

import jax

from dune_eigensolver_tpu.solvers.generalized import generalized_inverse
from dune_eigensolver_tpu.solvers.result import EigenResult


def save_checkpoint(path: str, Q, iterations: int, eigenvalues=None) -> None:
    """Atomic write (tmp + rename) of the solver state."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(
                fh,
                Q=np.asarray(Q),
                iterations=np.int64(iterations),
                eigenvalues=(
                    np.asarray(eigenvalues)
                    if eigenvalues is not None
                    else np.zeros(0)
                ),
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str):
    """(Q, iterations) or None if no checkpoint exists."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return z["Q"], int(z["iterations"])


def generalized_inverse_checkpointed(
    A,
    B,
    nev: int,
    tol: float,
    maxiter: int,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    shift: float = 0.0,
    reg: float = 0.0,
    min_iter: int = 10,
    inverse: Optional[Callable] = None,
    verbose: int = 0,
    **solver_kw,
) -> EigenResult:
    """generalized_inverse with segmented execution + on-disk checkpoints.

    Same contract as generalized_inverse; if ``checkpoint_path`` holds a
    checkpoint from an interrupted run, execution resumes there."""
    if inverse is None:
        from dune_eigensolver_tpu.factorize import default_inverse_factory

        A_sh = A
        if shift != 0.0:
            A_sh = A_sh.axpy(shift, B)
        if reg != 0.0:
            A_sh = A_sh.with_shifted_diagonal(reg)
        prepared = default_inverse_factory(A_sh)
        inverse = lambda _ignored: prepared

    from dune_eigensolver_tpu.solvers.standard import padded_width

    block = solver_kw.get("block", 8)
    m = padded_width(nev, block)  # checkpoint the full padded iterate block

    q0 = None
    done = 0
    state = load_checkpoint(checkpoint_path)
    if state is not None:
        q0, done = state
        q0 = jax.numpy.asarray(q0)
        if verbose > 0:
            print(f"checkpoint: resuming at iteration {done}")

    res = None
    while done < maxiter:
        seg = min(checkpoint_every, maxiter - done)
        res = generalized_inverse(
            A,
            B,
            nev=m,  # keep all m columns so restarts lose no subspace
            tol=tol,
            maxiter=seg,
            shift=shift,
            reg=reg,
            min_iter=max(0, min_iter - done),
            inverse=inverse,
            q0=q0,
            **solver_kw,
        )
        done += int(res.iterations)
        Q = res.eigenvectors  # (n, m): sorted orthonormal basis, full width
        save_checkpoint(checkpoint_path, Q, done, res.eigenvalues)
        if verbose > 0:
            print(
                f"checkpoint: segment done, iterations={done} "
                f"criterion={float(res.criterion):.3e}"
            )
        if bool(res.converged) and done > min_iter:
            break
        q0 = Q
    if res is None:  # maxiter <= done at entry (fully resumed run)
        res = generalized_inverse(
            A, B, nev=m, tol=tol, maxiter=1, shift=shift, reg=reg,
            min_iter=0, inverse=inverse, q0=q0, **solver_kw,
        )
    return EigenResult(
        eigenvalues=res.eigenvalues[:nev],
        eigenvectors=res.eigenvectors[:, :nev],
        iterations=jax.numpy.asarray(done, jax.numpy.int32),
        converged=res.converged,
        criterion=res.criterion,
        ortho_monitor=res.ortho_monitor,
    )


def lobpcg_generalized_checkpointed(
    A,
    B,
    nev: int,
    tol: float,
    maxiter: int,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    shift: float = 0.0,
    reg: float = 0.0,
    min_iter: int = 3,
    precond: Optional[Callable] = None,
    verbose: int = 0,
    **solver_kw,
) -> EigenResult:
    """lobpcg_generalized with segmented execution + on-disk checkpoints —
    the long-run production path (the 10M-dof north-star solve iterates for
    tens of seconds per segment; a pod-scale or tighter-tolerance run for
    minutes-to-hours).

    LOBPCG's full state is (X, P); the checkpoint persists only the Ritz
    block X (same file format as the subspace-iteration checkpoint), so a
    resume warm-starts from X and rebuilds the conjugate direction P over
    the first segment iteration — a one-iteration momentum loss, never a
    correctness loss. Same contract as ``lobpcg_generalized`` otherwise.
    """
    from dune_eigensolver_tpu.solvers.lobpcg import lobpcg_generalized
    from dune_eigensolver_tpu.solvers.standard import padded_width

    block = solver_kw.get("block", 8)
    m = padded_width(nev, block)  # checkpoint the full padded iterate block

    q0 = None
    done = 0
    state = load_checkpoint(checkpoint_path)
    if state is not None:
        q0, done = state
        q0 = jax.numpy.asarray(q0)
        if verbose > 0:
            print(f"checkpoint: resuming at iteration {done}")

    res = None
    while done < maxiter:
        seg = min(checkpoint_every, maxiter - done)
        res = lobpcg_generalized(
            A,
            B,
            nev=m,  # keep all m columns so restarts lose no subspace
            tol=tol,
            maxiter=seg,
            shift=shift,
            reg=reg,
            min_iter=max(0, min_iter - done),
            precond=precond,
            q0=q0,
            **solver_kw,
        )
        done += int(res.iterations)
        Q = res.eigenvectors  # (n, m) B-normalized Ritz block, full width
        save_checkpoint(checkpoint_path, Q, done, res.eigenvalues)
        if verbose > 0:
            print(
                f"checkpoint: segment done, iterations={done} "
                f"criterion={float(res.criterion):.3e}"
            )
        if bool(res.converged) and done > min_iter:
            break
        q0 = Q
    if res is None:  # maxiter <= done at entry (fully resumed run)
        res = lobpcg_generalized(
            A, B, nev=m, tol=tol, maxiter=1, shift=shift, reg=reg,
            min_iter=0, precond=precond, q0=q0, **solver_kw,
        )
    return EigenResult(
        eigenvalues=res.eigenvalues[:nev],
        eigenvectors=res.eigenvectors[:, :nev],
        iterations=jax.numpy.asarray(done, jax.numpy.int32),
        converged=res.converged,
        criterion=res.criterion,
        ortho_monitor=res.ortho_monitor,
    )
