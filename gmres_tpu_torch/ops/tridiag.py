"""Batched tridiagonal solves by parallel cyclic reduction (PCR).

Counterpart of ``gmres_tpu/ops/tridiag.py``: ⌈log₂ n⌉ steps of elementwise
arithmetic on shifted copies (``torch.roll``) and masks, over a whole batch
of systems along the last axis, with any n (a power of two or not). No
pivoting: meant for the diagonally dominant systems of line relaxation
(``precond/multigrid.py:anisotropic_multigrid_preconditioner``). Plain
PyTorch on any device, as the JAX version is plain jnp.

The elimination of a, b and c never reads the right-hand side, so
``pcr_plan`` runs it once and ``pcr_apply`` replays its coefficients on a
right-hand side; ``tridiag_solve_pcr`` is the two in turn, operation for
operation the JAX function's.
"""

from __future__ import annotations

import torch


def pcr_plan(dl: torch.Tensor, dd: torch.Tensor, du: torch.Tensor) -> tuple:
    """The right-hand-side-independent half of PCR for T = tridiag(dl, dd,
    du) along the last axis (dl[..., 0] and du[..., -1] ignored): the
    per-step (shift, α, γ, masks of the rows with a neighbour s below and
    above) and the final diagonal b, the tensors of
    ``tridiag_solve_pcr``'s elimination. Any shapes that broadcast against
    the right-hand sides (one row of coefficients serves every line)."""
    n = dd.shape[-1]
    i = torch.arange(n, device=dd.device)
    a = torch.where(i > 0, dl, 0.0)
    b = dd
    c = torch.where(i < n - 1, du, 0.0)
    steps = []
    s = 1
    while s < n:
        has_m, has_p = i >= s, i < n - s
        b_m = torch.roll(b, s, dims=-1)
        c_m = torch.roll(c, s, dims=-1)
        a_m = torch.roll(a, s, dims=-1)
        b_p = torch.roll(b, -s, dims=-1)
        a_p = torch.roll(a, -s, dims=-1)
        c_p = torch.roll(c, -s, dims=-1)
        alpha = torch.where(has_m, -a / b_m, 0.0)
        gamma = torch.where(has_p, -c / b_p, 0.0)
        a = alpha * torch.where(has_m, a_m, 0.0)
        c = gamma * torch.where(has_p, c_p, 0.0)
        b = (b + alpha * torch.where(has_m, c_m, 0.0)
             + gamma * torch.where(has_p, a_p, 0.0))
        steps.append((s, alpha, gamma, has_m, has_p))
        s *= 2
    return steps, b


def pcr_apply(plan: tuple, rhs: torch.Tensor) -> torch.Tensor:
    """The solve of ``pcr_plan``'s system for ``rhs`` (..., n)."""
    steps, b = plan
    d = rhs
    for s, alpha, gamma, has_m, has_p in steps:
        d_m = torch.roll(d, s, dims=-1)
        d_p = torch.roll(d, -s, dims=-1)
        d = (d + alpha * torch.where(has_m, d_m, 0.0)
             + gamma * torch.where(has_p, d_p, 0.0))
    return d / b


def tridiag_solve_pcr(
    dl: torch.Tensor,
    dd: torch.Tensor,
    du: torch.Tensor,
    rhs: torch.Tensor,
) -> torch.Tensor:
    """Solve T x = rhs along the LAST axis for a batch of tridiagonal
    systems (the arguments of ``gmres_tpu.ops.tridiag.tridiag_solve_pcr``).

      dl: sub-diagonal, same shape as rhs (dl[..., 0] ignored).
      dd: main diagonal.
      du: super-diagonal (du[..., -1] ignored).
      rhs: right-hand sides, (..., n).

    Returns x with rhs's shape, after ⌈log₂ n⌉ elementwise steps."""
    return pcr_apply(pcr_plan(dl, dd, du), rhs)
