"""Incremental Givens-rotation QR of the Hessenberg matrix.

Counterpart of ``gmres_tpu/ops/givens.py``: the accumulated rotation
product is kept as a small dense orthogonal matrix Ω (m+1, m+1), so
applying every earlier rotation to a new column is one matvec, and each
step rotates two rows of Ω and two entries of g.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GivensState(NamedTuple):
    """omega: (m+1, m+1) product of all rotations so far.
    g: (m+1,) rotated rhs; |g[t+1]| is the running residual norm.
    beta0: the ‖b‖ normalizer for relative residuals (0-d tensor)."""

    omega: torch.Tensor
    g: torch.Tensor
    beta0: torch.Tensor


def givens_init(m: int, g0: torch.Tensor, beta0=None) -> GivensState:
    """Fresh state for a restart cycle; g0 is the initial (m+1,) rhs."""
    if beta0 is None:
        beta0 = torch.ones((), dtype=g0.dtype, device=g0.device)
    return GivensState(
        omega=torch.eye(m + 1, dtype=g0.dtype, device=g0.device), g=g0,
        beta0=torch.as_tensor(beta0, dtype=g0.dtype, device=g0.device),
    )


def givens_step(state: GivensState, hcol: torch.Tensor, t: int) -> tuple[
    GivensState, torch.Tensor, torch.Tensor
]:
    """Process Hessenberg column t (0-based).

    hcol: (m+1,) raw column (entries beyond t+1 must be zero).
    Returns (new_state, rotated_column, residual_component): the rotated
    column is upper-triangular and residual_component = g[t+1] after the
    new rotation. The input state's tensors are not modified.
    """
    omega, g, beta0 = state
    hrot = omega @ hcol

    ct = hrot[t]
    ct1 = hrot[t + 1]
    ds = torch.hypot(ct1.abs(), ct.abs())
    safe = torch.where(ds > 0, ds, torch.ones_like(ds))
    cs = torch.where(ds > 0, ct.conj() / safe, torch.ones_like(ct))
    sn = torch.where(ds > 0, ct1.conj() / safe, torch.zeros_like(ct1))

    col = hrot.clone()
    col[t] = cs * ct + sn * ct1
    col[t + 1] = 0

    # Ω ← G_t Ω : rotate rows t and t+1.
    row_t, row_t1 = omega[t], omega[t + 1]
    omega_new = omega.clone()
    omega_new[t] = cs * row_t + sn * row_t1
    omega_new[t + 1] = -sn.conj() * row_t + cs.conj() * row_t1

    gt, gt1 = g[t], g[t + 1]
    g_new = g.clone()
    g_new[t] = cs * gt + sn * gt1
    g_new[t + 1] = -sn.conj() * gt + cs.conj() * gt1

    return GivensState(omega=omega_new, g=g_new, beta0=beta0), col, g_new[t + 1]
