"""Small dense solves: the masked triangular solve of the projected GMRES
system, and the general solve of the deflated and IDR(s) solvers.

Counterpart of ``gmres_tpu/ops/tri.py``. ``masked_back_substitution``: the
full static (m, m) system is solved after replacing rows/cols ≥ k by the
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


def solve_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense solve of a small replicated system a x = b (b a vector or a
    block of columns).

    Counterpart of ``gmres_tpu/ops/tri.py:solve_small``. JAX eliminates
    by hand there because the TPU has no float64 LU; here the library's LU
    (``torch.linalg.solve_ex``) does it. The contract for a singular input
    is JAX's: an exactly zero pivot (LAPACK's ``info > 0``) makes every
    entry of the result NaN. No value is read back from the device.
    """
    x, info = torch.linalg.solve_ex(a, b.to(a.dtype))
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))
