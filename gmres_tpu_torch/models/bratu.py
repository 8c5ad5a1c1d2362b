"""2-D Bratu problem: −Δu = λ e^u on the unit square, u = 0 on ∂Ω.

Counterpart of ``gmres_tpu/models/bratu.py``: with the 5-point stencil
scaled by h², the residual is

    F(u) = A u − λ h² e^u          (A = unit 5-point stencil),

the classic Jacobian-free Newton-Krylov test problem. A is
``poisson_apply``: K1 on a CUDA tensor, differentiable by K1's rules, so
``torch.func.jvp`` of F (``solvers/newton_krylov.py``) gives the exact
J·v = A v − λh² e^u ⊙ v with one K1 launch for the primal and one for
the tangent.
"""

from __future__ import annotations

from typing import Callable

import torch

from gmres_tpu_torch.models.poisson import poisson_apply


def bratu_residual(nsize: int, lam: float = 5.0,
                   dtype=torch.float64) -> Callable:
    """F(u) for the nsize×nsize interior grid; λ in (0, λ* ≈ 6.808) has
    two solution branches, and Newton from u₀ = 0 finds the lower one.
    λh² is rounded to ``dtype`` once, as gmres_tpu rounds it, and kept as
    a Python number (no device copy per call)."""
    h = 1.0 / (nsize + 1)
    lam_h2 = float(torch.tensor(lam * h * h, dtype=dtype))

    def residual(u: torch.Tensor) -> torch.Tensor:
        return poisson_apply(u) - lam_h2 * torch.exp(u)

    return residual


def bratu_dense_residual(nsize: int, lam: float = 5.0):
    """NumPy oracle residual over the flat (nsize²,) vector."""
    import numpy as np

    h = 1.0 / (nsize + 1)
    lam_h2 = lam * h * h

    def residual(u_flat):
        u = np.asarray(u_flat, dtype=np.float64).reshape(nsize, nsize)
        au = 4.0 * u
        au[:-1, :] -= u[1:, :]
        au[1:, :] -= u[:-1, :]
        au[:, :-1] -= u[:, 1:]
        au[:, 1:] -= u[:, :-1]
        return (au - lam_h2 * np.exp(u)).reshape(-1)

    return residual
