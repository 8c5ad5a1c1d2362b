"""Hilbert matrix: the ill-conditioned dense orthogonality stress test.

Counterpart of ``gmres_tpu/models/hilbert.py``: H(i, j) = 1/(i + j − 1),
1-based. The reference computes the entry in single precision before
storing it in real(8); ``reference_rounding=True`` reproduces those bits
(one correctly rounded float32 division per entry, then the cast).
"""

from __future__ import annotations

import torch


def hilbert_matrix(n: int, dtype=torch.float64, reference_rounding: bool = False,
                   device="cuda") -> torch.Tensor:
    """The n×n Hilbert matrix in ``dtype`` on ``device`` (the card unless
    the caller asks for the CPU)."""
    i = torch.arange(1, n + 1, dtype=torch.int32, device=device)
    denom = i[:, None] + i[None, :] - 1
    if reference_rounding:
        d32 = denom.to(torch.float32)
        return torch.div(torch.ones_like(d32), d32).to(dtype)
    d = denom.to(dtype)
    return torch.div(torch.ones_like(d), d)
