"""Core result/status types of the PyTorch port.

Counterpart of ``gmres_tpu/types.py``: the same status codes and the same
GMRES, CG, eigen, Newton and block result fields, as plain dataclasses over tensors (no pytree
registration is needed in eager PyTorch).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable

import numpy as np
import torch

# A linear operator is any callable y = A(x) mapping a tensor to a tensor
# of the same shape; the grid shape travels in the closure.
LinearOperator = Callable[[Any], Any]

# A preconditioner is z = M⁻¹(r): same contract as the operator.
Preconditioner = Callable[[Any], Any]


class SolverStatus(enum.IntEnum):
    """Termination status (same codes as ``gmres_tpu.SolverStatus``)."""

    CONVERGED = 0
    MAX_ITERATIONS = 1
    BREAKDOWN = 2


def _fields_numpy(res, names) -> dict:
    out = {}
    for name in names:
        v = getattr(res, name)
        out[name] = (v.detach().cpu().numpy()
                     if isinstance(v, torch.Tensor) else np.asarray(v))
    return out


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Result of a CG solve.

    Attributes (the fields of ``gmres_tpu.SolveResult``):
      x: solution tensor, shaped like b.
      iterations: iterations performed.
      residual: final absolute residual ‖r‖₂, a 0-d tensor (the true
        residual ‖b − A x‖ once an iteration ran).
      status: SolverStatus code.
      residual_history: (max_iterations,) per-iteration ‖r‖₂, padded with
        the final residual past the last iteration.

    The loop counters are Python ints, as in ``GmresResult``.

    Beyond the JAX fields:
      host_syncs: device→host reads the solve made to decide its loop: the
        initial residual, one per iteration, the final certification, and
        the target when ``rtol`` is given.
    """

    x: torch.Tensor
    iterations: int
    residual: torch.Tensor
    status: int
    residual_history: torch.Tensor
    host_syncs: int = 0

    @property
    def converged(self) -> bool:
        return self.status == SolverStatus.CONVERGED

    def to_numpy(self) -> dict:
        """The JAX result fields as numpy values, for field-by-field
        comparison with ``gmres_tpu``."""
        return _fields_numpy(self, ("x", "iterations", "residual", "status",
                                    "residual_history"))


@dataclasses.dataclass(frozen=True)
class GmresResult:
    """Result of a restarted GMRES(m) solve.

    Attributes (the fields of ``gmres_tpu.GmresResult``):
      x: solution tensor.
      iterations: inner iterations in the final restart cycle (``n_out``).
      restarts: restart cycles performed.
      residual: final relative residual, a 0-d tensor.
      status: SolverStatus code.
      residual_history: (m,) per-inner-iteration relative residual of the
        last restart cycle.
      v_err: (m+1,) orthogonality audit (zeros unless requested).

    The loop counters are Python ints: the eager loops decide on the host,
    so they are known there without another device read.

    Beyond the JAX fields:
      host_syncs: device→host reads the solve made to decide its loops
        (one per inner iteration that tests convergence, one per restart,
        one for the initial residual). On a CUDA tensor each is a stream
        synchronisation.
    """

    x: torch.Tensor
    iterations: int
    restarts: int
    residual: torch.Tensor
    status: int
    residual_history: torch.Tensor
    v_err: torch.Tensor
    host_syncs: int = 0

    @property
    def converged(self) -> bool:
        return self.status == SolverStatus.CONVERGED

    def to_numpy(self) -> dict:
        """The JAX result fields as numpy values, for field-by-field
        comparison with ``gmres_tpu``."""
        return _fields_numpy(self, ("x", "iterations", "restarts", "residual",
                                    "status", "residual_history", "v_err"))


@dataclasses.dataclass(frozen=True)
class EigResult:
    """Result of an eigensolve (``solvers/lobpcg.py``, ``arnoldi.py``,
    ``krylov_schur_real.py``, ``subspace_eigs.py``).

    Attributes (the fields of ``gmres_tpu.EigResult``):
      eigenvalues: (k,) eigenvalues: real and ascending for LOBPCG; complex
        and most-wanted first for the nonsymmetric solvers.
      x: (k, *shape) unit (B-orthonormal for a pencil) eigenvectors, rows.
      iterations: LOBPCG iterations, or restart cycles, or subspace
        iterations.
      residuals: (k,) certified ‖A xᵢ − λᵢ (B) xᵢ‖₂ per pair.
      status: SolverStatus code (CONVERGED iff every pair converged).

    The counters are Python ints. Beyond the JAX fields:
      host_syncs: device→host reads the solve made: each host eigensolve
        of a small projected matrix and each loop decision.
    """

    eigenvalues: torch.Tensor
    x: torch.Tensor
    iterations: int
    residuals: torch.Tensor
    status: int
    host_syncs: int = 0

    @property
    def converged(self) -> bool:
        return self.status == SolverStatus.CONVERGED

    def to_numpy(self) -> dict:
        """The JAX result fields as numpy values."""
        return _fields_numpy(self, ("eigenvalues", "x", "iterations", "residuals",
                                    "status"))


@dataclasses.dataclass(frozen=True)
class NewtonResult:
    """Result of a Jacobian-free Newton-Krylov solve
    (``solvers/newton_krylov.py``).

    Attributes (the fields of ``gmres_tpu.NewtonResult``):
      x: solution with ‖F(x)‖₂ ≤ tol (on CONVERGED).
      iterations: Newton steps performed.
      residual: final ‖F(x)‖₂, a 0-d tensor, always freshly evaluated at
        the returned x.
      status: SolverStatus code; BREAKDOWN = the Armijo line search found
        no decreasing step (stagnation or NaN).
      residual_history: (max_newton,) per-step ‖F‖₂, padded with the final
        value.
      inner_iterations: linear inner iterations summed over the Newton
        steps, counted as gmres_tpu counts them.

    Beyond the JAX fields:
      host_syncs: device→host reads of the Newton loop itself (‖F‖ once a
        trial point) plus the inner solves' own.
      jv_products: J·v applications the inner solves made.
    """

    x: torch.Tensor
    iterations: int
    residual: torch.Tensor
    status: int
    residual_history: torch.Tensor
    inner_iterations: int
    host_syncs: int = 0
    jv_products: int = 0

    @property
    def converged(self) -> bool:
        return self.status == SolverStatus.CONVERGED

    def to_numpy(self) -> dict:
        """The JAX result fields as numpy values."""
        return _fields_numpy(self, ("x", "iterations", "residual", "status",
                                    "residual_history", "inner_iterations"))


@dataclasses.dataclass(frozen=True)
class BlockSolveResult:
    """Result of a block (multi-RHS) solve.

    Attributes (the fields of ``gmres_tpu.BlockSolveResult``):
      x: (s, *shape) stacked solutions.
      restarts: restart cycles performed.
      residuals: (s,) final relative residual per right-hand side.
      residual: max over ``residuals`` (the convergence gate), a 0-d tensor.
      status: SolverStatus code (CONVERGED iff every RHS converged).

    Beyond the JAX fields:
      host_syncs: device→host reads the solve made to decide its loop: the
        initial residuals and one per restart cycle.
    """

    x: torch.Tensor
    restarts: int
    residuals: torch.Tensor
    residual: torch.Tensor
    status: int
    host_syncs: int = 0

    @property
    def converged(self) -> bool:
        return self.status == SolverStatus.CONVERGED

    def to_numpy(self) -> dict:
        """The JAX result fields as numpy values."""
        return _fields_numpy(self, ("x", "restarts", "residuals", "residual",
                                    "status"))


def as_tensor(a, device, dtype=None) -> torch.Tensor:
    """A numpy array (b, x0, a dense A) as a tensor on an explicit device,
    cast to ``dtype`` when given. Copies, so the caller's array is never
    aliased by the solver's in-place buffers."""
    t = torch.as_tensor(np.asarray(a)).to(device=device, copy=True)
    return t if dtype is None else t.to(dtype)
