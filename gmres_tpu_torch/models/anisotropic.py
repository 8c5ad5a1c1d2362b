"""Anisotropic diffusion ε·u_xx + u_yy.

Counterpart of ``gmres_tpu/models/anisotropic.py``, h²-scaled like every
stencil here:

    (A u)ᵢⱼ = ε(2uᵢⱼ − uᵢ₋₁ⱼ − uᵢ₊₁ⱼ) + (2uᵢⱼ − uᵢⱼ₋₁ − uᵢⱼ₊₁),

the strong coupling along axis 1 (the last). ε = 1 is the Poisson stencil.

Routing, as every constant-coefficient 5-point stencil of the port: a CUDA
tensor launches kernel K1 with the coefficients ``anisotropic_coefs(ε)``
(``ops/stencil.py:stencil_5pt_routed_general``); a CPU tensor takes the
JAX module's pad-and-sum form, so that the CPU runs round as JAX's do. A
DTensor on either device takes the stencil's DTensor route (one halo
exchange, K1's halo form on a CUDA block, its plain version on a CPU one).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from gmres_tpu_torch.ops.blas import row_blocks
from gmres_tpu_torch.ops.stencil import on_sharded_grid, stencil_5pt_routed_general


def anisotropic_coefs(eps: float) -> tuple:
    """(center, west, east, south, north) of the operator, in
    ``stencil_5pt_general``'s order: (2ε + 2, −1, −1, −ε, −ε)."""
    e = float(eps)
    return (2.0 * e + 2.0, -1.0, -1.0, -e, -e)


def anisotropic_apply(x: torch.Tensor, eps: float) -> torch.Tensor:
    """One application; eps scales the axis-0 (weak) coupling."""
    if x.device.type != "cpu" or on_sharded_grid(x):
        return stencil_5pt_routed_general(x, anisotropic_coefs(eps))
    xp = F.pad(x, (1, 1, 1, 1))
    return (eps * (2.0 * x - xp[:-2, 1:-1] - xp[2:, 1:-1])
            + (2.0 * x - xp[1:-1, :-2] - xp[1:-1, 2:]))


def anisotropic_operator(nsize: int, eps: float) -> Callable:
    """Matrix-free operator closure (nsize is kept for the JAX signature;
    the shape travels with x)."""
    del nsize

    def apply(x: torch.Tensor) -> torch.Tensor:
        return anisotropic_apply(x, eps)

    return row_blocks(apply)


def anisotropic_matrix(nsize: int, eps: float, dtype=torch.float64,
                       device="cuda") -> torch.Tensor:
    """Dense assembly (C-order) for small-n oracles, built on ``device``
    (the card unless the caller asks for the CPU)."""
    eye = torch.eye(nsize, dtype=dtype, device=device)
    ones = torch.ones(nsize - 1, dtype=dtype, device=device)
    lap1 = 2.0 * eye - torch.diag(ones, 1) - torch.diag(ones, -1)
    return eps * torch.kron(lap1, eye) + torch.kron(eye, lap1)
