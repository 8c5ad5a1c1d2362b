"""Masked triangular solve for the projected GMRES system.

Counterpart of ``gmres_tpu/ops/tri.py:masked_back_substitution``: the full
static (m, m) system is solved after replacing rows/cols ≥ k by the
identity with zero rhs, so the unknowns beyond k come out exactly zero.
"""

from __future__ import annotations

import torch


def masked_back_substitution(
    h: torch.Tensor, g: torch.Tensor, k: int
) -> torch.Tensor:
    """Solve H[:k,:k] y = g[:k]; return (m,) y padded with zeros.

    h: (m+1, m) rotated (upper-triangular) Hessenberg storage.
    g: (m+1,) rotated rhs.
    k: number of valid columns.
    """
    m = h.shape[1]
    idx = torch.arange(m, device=h.device)
    active = (idx[:, None] < k) & (idx[None, :] < k)
    eye = torch.eye(m, dtype=h.dtype, device=h.device)
    hm = torch.where(active, h[:m, :m], eye)
    gm = torch.where(idx < k, g[:m], torch.zeros_like(g[:m]))
    return torch.linalg.solve_triangular(hm, gm[:, None], upper=True)[:, 0]
