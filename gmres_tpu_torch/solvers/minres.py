"""MINRES for symmetric (possibly indefinite) systems, in eager PyTorch.

Counterpart of ``gmres_tpu/solvers/minres.py`` (Paige & Saunders 1975):
the Lanczos three-term recurrence in the M-inner product and a running
Givens QR of its tridiagonal, with the JAX solver's update order:

* per iteration one operator and one preconditioner application and two
  reductions, α = (v, Av) and β² = (r, Mr);
* convergence on the absolute residual estimate |φ̄| < tol (with M, the
  M-norm ‖b − A x‖_M);
* exit certification in that norm: one more A (and M) recomputes the true
  residual, and a CONVERGED claim it fails becomes BREAKDOWN;
* a non-finite estimate (β² < 0 from an indefinite M, or a Krylov space
  exhausted unconverged) is BREAKDOWN.

Every Lanczos and Givens scalar is real, also for a complex Hermitian A
(and HPD M): (r, Mr) and (v, Av) are real, ``tree_vdot`` conjugates its
first argument, and the scalars are kept in the real dtype of b.

``lax.while_loop`` becomes a Python loop. The scalars stay on the device
as 0-d tensors; the loop reads the estimate back once an iteration and
decides on the host. ``SolveResult.host_syncs`` counts the reads: β₁, one
an iteration and the certification.

The loop is a generator of steps (``minres_steps``): each application of A
or M and each read is a request to its runner (``solvers/requests.py``).
``minres`` drives it on its own; ``solvers/batched.py`` drives one per
lane of a batched solve.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from gmres_tpu_torch.ops.blas import tree_sub, tree_vdot, tree_zeros_like
from gmres_tpu_torch.solvers.cg import _in_dtype
from gmres_tpu_torch.solvers.requests import Apply, Read, run
from gmres_tpu_torch.types import (
    LinearOperator,
    Preconditioner,
    SolveResult,
    SolverStatus,
)


def minres(
    A: LinearOperator,
    b: Any,
    *,
    tol: float = 1e-9,
    max_iterations: int = 10_000,
    M: Optional[Preconditioner] = None,
    x0: Optional[Any] = None,
) -> SolveResult:
    """Solve A x = b (A symmetric or Hermitian, definite or not) by
    (preconditioned) MINRES (the arguments of ``gmres_tpu.minres``). M, if
    given, must be SPD (HPD): it defines the Lanczos inner product. x0
    defaults to zeros; tol is absolute."""
    return run(minres_steps(A, b, tol=tol, max_iterations=max_iterations, M=M,
                            x0=x0))


def minres_steps(A, b, *, tol=1e-9, max_iterations=10_000, M=None, x0=None):
    """``minres``'s solve as steps (``solvers/requests.py``), returning its
    SolveResult."""
    if x0 is None:
        x = tree_zeros_like(b)
        r1 = b
    else:
        x = x0
        r1 = tree_sub(b, (yield Apply(A, x0)))
    rdtype = b.real.dtype
    tol = _in_dtype(tol, rdtype)

    def prec(v):
        return (yield Apply(M, v)) if M is not None else v

    z = yield from prec(r1)
    beta1 = torch.sqrt(tree_vdot(r1, z).real)
    beta1_f = yield Read(beta1)
    status = int(SolverStatus.CONVERGED if beta1_f < tol
                 else SolverStatus.MAX_ITERATIONS)
    syncs = 1
    eps = torch.tensor(torch.finfo(rdtype).tiny, dtype=rdtype,
                       device=b.device) ** 0.5
    zero = torch.zeros((), dtype=rdtype, device=b.device)
    one = torch.ones((), dtype=rdtype, device=b.device)
    r2 = r1
    w1 = w2 = tree_zeros_like(b)
    beta, oldb, dbar, epsln, phibar = beta1, one, zero, zero, beta1
    cs, sn = -one, zero
    history = []
    i = 0
    while i < max_iterations and status == SolverStatus.MAX_ITERATIONS:
        # Lanczos step in the M-inner product: v = z/β, y = A v
        # orthogonalised against the two previous directions.
        v = (1.0 / beta) * z
        y = yield Apply(A, v)
        if i > 0:
            y = y + (-beta / oldb) * r1
        alfa = tree_vdot(v, y).real
        y = y + (-alfa / beta) * r2
        r1, r2 = r2, y
        z = yield from prec(y)
        oldb = beta
        beta_sq = tree_vdot(r2, z).real
        beta = torch.sqrt(beta_sq)

        # Running Givens QR of the tridiagonal: the previous rotation on
        # the new column, then the new rotation.
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.maximum(torch.sqrt(gbar * gbar + beta_sq), eps)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar

        # Solution update along the rotated direction.
        w = (1.0 / gamma) * (v + (-delta) * w2 + (-oldeps) * w1)
        w1, w2 = w2, w
        x = x + phi * w

        res_f = abs((yield Read(phibar)))
        syncs += 1
        history.append(res_f)
        if res_f < tol:
            status = int(SolverStatus.CONVERGED)
        elif not math.isfinite(res_f):
            status = int(SolverStatus.BREAKDOWN)
        i += 1

    # Certify in the tested norm (the M-norm when preconditioned).
    r_true = tree_sub(b, (yield Apply(A, x)))
    true_res = torch.sqrt(tree_vdot(r_true, (yield from prec(r_true))).real)
    true_f = yield Read(true_res)
    syncs += 1
    if status == SolverStatus.CONVERGED and true_f >= tol:
        status = int(SolverStatus.BREAKDOWN)
    res, res_f = (true_res, true_f) if i > 0 else (beta1, beta1_f)
    hist = torch.tensor(history + [res_f] * (max_iterations - i), dtype=rdtype,
                        device=b.device)
    return SolveResult(x=x, iterations=i, residual=res, status=status,
                       residual_history=hist, host_syncs=syncs)
