"""LSQR (Paige & Saunders 1982): least squares min ‖Ax − b‖₂, in eager
PyTorch.

Counterpart of ``gmres_tpu/solvers/lsqr.py``, with the same Golub–Kahan
bidiagonalisation, rotations (the damping row eliminated first), stopping
tests and certification. A may map between different shapes (rectangular
operators; ``x_like`` gives the solution's shape and dtype).

The adjoint. gmres_tpu derives Aᴴ as conj ∘ linear_transpose ∘ conj; here
it is the pullback of ``torch.func.vjp`` of A at ``x_like``
(``solvers/requests.py:derived_transpose``), which for a complex operator is
already the adjoint — conjugating around it would give Aᵀ, not Aᴴ. On a
CUDA tensor a stencil A is K1's full-grid route, whose backward is one K1
launch with the mirrored coefficients: a solve launches K1 once at setup
(the vjp's primal), twice an iteration (A v, Aᴴ u) and twice at the
certification (A x, Aᴴ r).

The scalar recurrence stays on the device as 0-d tensors; one host read an
iteration brings back the two stopping estimates. ``host_syncs`` counts
the reads: one at setup, one per iteration and one at the certification.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from gmres_tpu_torch.ops.blas import tree_norm, tree_zeros_like
from gmres_tpu_torch.solvers.cg import _in_dtype
from gmres_tpu_torch.solvers.requests import Apply, Read, run, transposed
from gmres_tpu_torch.types import SolveResult, SolverStatus


def _normalize(v: torch.Tensor):
    """(v/‖v‖, ‖v‖), v unchanged where ‖v‖ = 0."""
    n = tree_norm(v)
    safe = torch.where(n > 0, n, torch.ones_like(n))
    return v / safe, n


def _certify(A, AH, b, x, damp, tol, atol, status):
    """The certification both least-squares solvers share: ‖b − A x‖ and
    the gradient norm ‖Aᴴr − damp²x‖ from the true residual; a CONVERGED
    claim that neither confirms becomes BREAKDOWN. Returns the true
    residual norm (a 0-d tensor and its value) and the status (steps:
    ``solvers/requests.py``)."""
    r_true = b - (yield Apply(A, x))
    res_true = tree_norm(r_true)
    grad = (yield Apply(AH, r_true)) - damp * damp * x
    res_f, grad_f = yield Read(torch.stack([res_true, tree_norm(grad)]))
    if status == SolverStatus.CONVERGED and not (res_f < tol or grad_f < atol):
        status = int(SolverStatus.BREAKDOWN)
    return res_true, res_f, status


def lsqr(
    A: Callable,
    b: torch.Tensor,
    *,
    x_like: Optional[torch.Tensor] = None,
    AH: Optional[Callable] = None,
    tol: float = 1e-9,
    atol: Optional[float] = None,
    max_iterations: int = 10_000,
    damp: float = 0.0,
) -> SolveResult:
    """Minimise ‖A x − b‖₂ (+ damp²‖x‖² when damp > 0).

    The arguments are those of ``gmres_tpu.lsqr``: ``tol`` the absolute ‖r‖
    stop, ``atol`` (default tol) the absolute ‖Aᴴr‖ stop, ``AH`` the
    adjoint (derived when omitted). ``iterations`` counts bidiagonalisation
    steps; ``residual`` is the certified ‖b − Ax‖₂ and
    ``residual_history`` the ‖r‖ estimates."""
    return run(lsqr_steps(A, b, x_like=x_like, AH=AH, tol=tol, atol=atol,
                          max_iterations=max_iterations, damp=damp))


def lsqr_steps(A, b, *, x_like=None, AH=None, tol=1e-9, atol=None,
               max_iterations=10_000, damp=0.0):
    """``lsqr``'s solve as steps (``solvers/requests.py``), returning its
    SolveResult. Aᴴ is ``requests.transposed`` when derived: in a batched
    solve one pullback for the lanes that ask together."""
    if x_like is None:
        x_like = b
    if atol is None:
        atol = tol
    rdtype = b.real.dtype if b.is_complex() else b.dtype
    tol, atol = _in_dtype(tol, rdtype), _in_dtype(atol, rdtype)
    if AH is None:
        AH = transposed(A, x_like)
    dev = b.device
    tiny = torch.finfo(rdtype).tiny

    def guard(t):
        return torch.clamp(t, min=tiny)

    x = tree_zeros_like(x_like)
    u, beta = _normalize(b)
    v, alfa = _normalize((yield Apply(AH, u)))
    w = v
    phibar, rhobar = beta, alfa
    arnorm0 = alfa * beta
    beta_f, arnorm0_f = yield Read(torch.stack([beta, arnorm0]))
    syncs = 1
    status = int(SolverStatus.CONVERGED if (beta_f < tol or arnorm0_f < atol)
                 else SolverStatus.MAX_ITERATIONS)
    dampr = torch.tensor(damp, dtype=rdtype, device=dev)
    res2_sq = torch.zeros((), dtype=rdtype, device=dev)
    history = []
    i = 0
    while i < max_iterations and status == SolverStatus.MAX_ITERATIONS:
        # Golub–Kahan step: β u ← A v − α u ; α v ← Aᴴ u − β v.
        u, beta_n = _normalize((yield Apply(A, v)) - alfa * u)
        v_new, alfa_n = _normalize((yield Apply(AH, u)) - beta_n * v)
        # The damping row first (Paige–Saunders eqn 4.10); ψ stays in the
        # augmented residual ‖(b − Ax; damp·x)‖.
        rhobar1 = torch.hypot(rhobar, dampr)
        c1 = rhobar / guard(rhobar1)
        s1 = dampr / guard(rhobar1)
        psi = s1 * phibar
        res2_sq = res2_sq + psi * psi
        phibar1 = c1 * phibar
        rho = torch.hypot(rhobar1, beta_n)
        c = rhobar1 / guard(rho)
        s = beta_n / guard(rho)
        theta = s * alfa_n
        rhobar = -c * alfa_n
        phi = c * phibar1
        phibar = s * phibar1
        t1 = phi / guard(rho)
        t2 = -theta / guard(rho)
        x = x + t1 * w
        w = v_new + t2 * w
        v, alfa = v_new, alfa_n
        res_est = torch.sqrt(phibar * phibar + res2_sq)
        arnorm = (phibar * alfa_n * c).abs()
        res_f, ar_f = yield Read(torch.stack([res_est, arnorm]))
        syncs += 1
        history.append(res_f)
        if res_f < tol or ar_f < atol:
            status = int(SolverStatus.CONVERGED)
        if status == SolverStatus.MAX_ITERATIONS and not math.isfinite(res_f):
            status = int(SolverStatus.BREAKDOWN)
        i += 1

    res_true, res_f, status = yield from _certify(A, AH, b, x, dampr, tol, atol,
                                                      status)
    syncs += 1
    res, res_f = (res_true, res_f) if i > 0 else (beta, beta_f)
    hist = torch.tensor(history + [res_f] * (max_iterations - i), dtype=rdtype,
                        device=dev)
    return SolveResult(x=x, iterations=i, residual=res, status=status,
                       residual_history=hist, host_syncs=syncs)
