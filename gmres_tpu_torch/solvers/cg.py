"""Conjugate Gradient for SPD systems, with optional left preconditioner, in
eager PyTorch.

Counterpart of ``gmres_tpu/solvers/cg.py``, with the same update order,
reduction fusions and convergence semantics:

* rr = (r, z) and pAp = (Ap, p) come from one ``batched_vdot``, and so do
  ‖r‖² and the next (r, z).
* Convergence is on the ABSOLUTE residual ‖r‖₂ < tol, tested after the x/r
  update; ``rtol`` raises the target to max(tol, rtol·‖b‖).
* CONVERGED at a residual under tol; BREAKDOWN on a non-finite residual; a
  CONVERGED claim whose true residual ‖b − A x‖ fails re-verification
  downgrades to BREAKDOWN. ``residual_history`` is padded with the final
  residual, and an initial residual under tol skips the loop.

``lax.while_loop`` becomes a Python loop: each iteration reads its residual
norm from the device and decides on the host, with the comparison made in
the residual's dtype as JAX makes it. The history is kept from those reads,
so recording it costs no launch. ``SolveResult.host_syncs`` counts the
reads: the initial residual, one per iteration, the final certification,
and the target when ``rtol`` is given.

The loop is a generator of steps (``cg_steps``): each application of A or
M and each read is a request to its runner (``solvers/requests.py``).
``cg`` drives it on its own; ``solvers/batched.py`` drives one per lane of
a batched solve.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gmres_tpu_torch.ops.blas import (
    batched_vdot,
    tree_axpy,
    tree_sub,
    tree_vdot,
    tree_zeros_like,
)
from gmres_tpu_torch.solvers.requests import Apply, Read, run
from gmres_tpu_torch.types import (
    LinearOperator,
    Preconditioner,
    SolveResult,
    SolverStatus,
)


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """A Python float rounded to ``dtype`` (exact for float64)."""
    return torch.tensor(value, dtype=dtype).item()


def _status(res: float, tol: float, status: int) -> int:
    if res < tol:
        status = SolverStatus.CONVERGED
    if not math.isfinite(res):
        status = SolverStatus.BREAKDOWN
    return int(status)


def _finish(A, b, x, i, res, status, tol, history, max_iterations, syncs,
            rdtype):
    """Certify on the true residual (one extra matvec): a CONVERGED claim
    that fails re-verification downgrades to BREAKDOWN, and once an
    iteration ran the true norm is reported. The history is padded with
    the final residual. Steps (``solvers/requests.py``)."""
    r_true = tree_sub(b, (yield Apply(A, x)))
    true_res = torch.sqrt(tree_vdot(r_true, r_true).real)
    true_f = yield Read(true_res)
    if status == SolverStatus.CONVERGED and true_f >= tol:
        status = int(SolverStatus.BREAKDOWN)
    if i > 0:
        res, res_f = true_res, true_f
    else:
        res_f = yield Read(res)
    hist = torch.tensor(history + [res_f] * (max_iterations - i),
                        dtype=rdtype, device=b.device)
    return SolveResult(x=x, iterations=i, residual=res, status=status,
                       residual_history=hist, host_syncs=syncs + 1)


def cg(
    A: LinearOperator,
    b: torch.Tensor,
    *,
    tol: float = 1e-9,
    max_iterations: int = 10_000,
    M: Optional[Preconditioner] = None,
    x0: Optional[torch.Tensor] = None,
    variant: str = "classic",
    rtol: Optional[float] = None,
) -> SolveResult:
    """Solve A x = b (A SPD) by (preconditioned) conjugate gradients.

    The arguments are those of ``gmres_tpu.cg``: A and M are callables on
    tensors shaped like b (b's device is the solve's); M approximates A⁻¹;
    x0 defaults to zeros; tol is the absolute ‖r‖₂ target and rtol, when
    given, raises it to max(tol, rtol·‖b‖). variant is "classic" or
    "pipelined" (Ghysels–Vanroose: one fused reduction per iteration);
    anything else raises ValueError.
    """
    if variant not in ("classic", "pipelined"):
        raise ValueError(f"unknown cg variant {variant}")
    return run(cg_steps(A, b, tol=tol, max_iterations=max_iterations, M=M,
                        x0=x0, variant=variant, rtol=rtol))


def cg_steps(A, b, *, tol=1e-9, max_iterations=10_000, M=None, x0=None,
             variant="classic", rtol=None):
    """``cg``'s solve as steps (``solvers/requests.py``), returning its
    SolveResult."""
    rdtype = b.real.dtype
    syncs = 0
    if rtol is not None:
        nb = torch.sqrt(tree_vdot(b, b).real)
        tol = yield Read(torch.maximum(torch.as_tensor(tol, dtype=nb.dtype,
                                                       device=nb.device), rtol * nb))
        syncs += 1
    tol = _in_dtype(tol, rdtype)
    loop = _pipelined_cg if variant == "pipelined" else _classic_cg
    return (yield from loop(A, b, tol=tol, max_iterations=max_iterations, M=M,
                            x0=x0, rdtype=rdtype, syncs=syncs))


def _classic_cg(A, b, *, tol, max_iterations, M, x0, rdtype, syncs):
    if x0 is None:
        x = tree_zeros_like(b)
        r = b
    else:
        x = x0
        r = tree_sub(b, (yield Apply(A, x0)))
    z = (yield Apply(M, r)) if M is not None else r
    p = z

    res = torch.sqrt(tree_vdot(r, r).real).to(rdtype)
    # Already converged at x0 (e.g. b = 0): skip the loop entirely.
    status = int(SolverStatus.CONVERGED if (yield Read(res)) < tol
                 else SolverStatus.MAX_ITERATIONS)
    syncs += 1
    history = []
    i = 0
    while i < max_iterations and status == SolverStatus.MAX_ITERATIONS:
        ap = yield Apply(A, p)
        # One stacked reduction for rr = (r, z) and pAp = (Ap, p).
        rr, pap = batched_vdot([(r, z), (ap, p)]).real
        alpha = rr / pap
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, ap, r)
        z = (yield Apply(M, r)) if M is not None else r
        # ‖r‖² and the next (r, z) in one stacked reduction.
        res_sq, rz_new = batched_vdot([(r, r), (r, z)]).real
        res = torch.sqrt(res_sq)
        beta = rz_new / rr
        p = tree_axpy(beta, p, z)
        res_f = yield Read(res)
        syncs += 1
        history.append(res_f)
        status = _status(res_f, tol, status)
        i += 1
    return (yield from _finish(A, b, x, i, res, status, tol, history,
                               max_iterations, syncs, rdtype))


def _pipelined_cg(A, b, *, tol, max_iterations, M, x0, rdtype, syncs):
    """Pipelined preconditioned CG (Ghysels & Vanroose, 2014, alg. 4): one
    stacked reduction of (γ = r·u, δ = w·u, ‖r‖²) per iteration, and an
    A·M application (m = M w, n = A m) that does not depend on it.
    ``iterations`` counts x-updates."""
    if x0 is None:
        x = tree_zeros_like(b)
        r = b
    else:
        x = x0
        r = tree_sub(b, (yield Apply(A, x0)))
    u = (yield Apply(M, r)) if M is not None else r
    w = yield Apply(A, u)
    zeros = tree_zeros_like(b)
    z = q = p = s = zeros

    gamma, delta, rr0 = batched_vdot([(r, u), (w, u), (r, r)]).real
    res0 = torch.sqrt(rr0)
    status = int(SolverStatus.CONVERGED if (yield Read(res0)) < tol
                 else SolverStatus.MAX_ITERATIONS)
    syncs += 1
    history = []
    i = 0
    res = res0
    while i < max_iterations and status == SolverStatus.MAX_ITERATIONS:
        m = (yield Apply(M, w)) if M is not None else w
        n = yield Apply(A, m)
        if i == 0:
            beta = torch.zeros((), dtype=rdtype, device=b.device)
            alpha = gamma / delta
        else:
            beta = gamma / gamma_prev
            alpha = gamma / (delta - beta * gamma / alpha_prev)
        z = tree_axpy(beta, z, n)
        q = tree_axpy(beta, q, m)
        s = tree_axpy(beta, s, w)
        p = tree_axpy(beta, p, u)
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, s, r)
        u = tree_axpy(-alpha, q, u)
        w = tree_axpy(-alpha, z, w)
        gamma_new, delta_new, rr = batched_vdot([(r, u), (w, u), (r, r)]).real
        res = torch.sqrt(rr)
        res_f = yield Read(res)
        syncs += 1
        history.append(res_f)
        status = _status(res_f, tol, status)
        gamma_prev, alpha_prev = gamma, alpha
        gamma, delta = gamma_new, delta_new
        i += 1
    return (yield from _finish(A, b, x, i, res, status, tol, history,
                               max_iterations, syncs, rdtype))
