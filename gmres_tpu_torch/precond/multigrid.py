"""Geometric multigrid V-cycle preconditioner for the 5-point stencil.

Counterpart of ``gmres_tpu/precond/multigrid.py:poisson_multigrid_preconditioner``
and its intergrid transfers: the unit 5-point stencil at every level,
restriction = 2×2 block sum, prolongation = 2×2 replication, Chebyshev
smoothers on [λmax/band, λmax] and an order-``coarse_order`` Chebyshev
coarse solve over the coarsest grid's full spectrum.

Each non-coarsest level runs the pre-smoother, K1's residual-restrict form
(r − A e, restricted), the coarser level, K1's correct-residual form
(e + P ec and r − A(e + P ec)), the post-smoother and one add. On a CUDA
tensor the smoothers and the coarse solve launch K2 and the two forms K1;
on a CPU tensor each takes its plain version, which is the composition of
``stencil_5pt_general``, ``restrict_sum`` and ``prolong_repeat`` the JAX
cycle computes, so both routes keep the JAX cycle's arithmetic.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from gmres_tpu_torch.ops.stencil import (  # noqa: F401  (transfers re-exported)
    correct_residual,
    prolong_repeat,
    residual_restrict,
    restrict_sum,
)
from gmres_tpu_torch.precond.chebyshev import chebyshev_stencil_preconditioner


@dataclasses.dataclass(frozen=True)
class MultigridPlan:
    """The static plan of a V-cycle, as plain Python data.

    sizes: grid size of each level, finest first.
    pre_smooth / post_smooth / coarse: (θ, steps) of each Chebyshev
      polynomial — steps is the flat [a₀, b₀, …] list of
      ``chebyshev_k_scalars``.
    lam_min_coarse: the coarsest grid's exact λ_min (the coarse solve's
      interval is [lam_min_coarse, lam_max]).
    """

    sizes: tuple
    pre_smooth: tuple
    post_smooth: tuple
    coarse: tuple
    lam_min_coarse: float


def poisson_multigrid_preconditioner(
    nsize: int,
    levels: int | None = None,
    pre_smooth: int = 3,
    post_smooth: int = 3,
    coarse_order: int = 32,
    lam_max: float = 8.0,
    smooth_band: float = 4.0,
    mesh=None,
    replicate_below: int | None = None,
) -> Callable:
    """V-cycle preconditioner z ≈ A⁻¹r for the nsize×nsize Poisson stencil.

    levels: coarsening depth; default coarsens while the grid is even and
      > 16. nsize must be divisible by 2^(levels-1).
    pre/post_smooth: Chebyshev smoothing order on [λmax/band, λmax].
    coarse_order: Chebyshev order of the coarsest-level solve.
    mesh, replicate_below: the distributed cycle, not ported yet (ROADMAP
      queue 1, item 8); passing either raises NotImplementedError.

    The returned callable carries ``levels``, ``fine_equiv_sweeps`` (the
    fine-grid-equivalent stencil sweeps of one cycle) and ``plan``
    (a ``MultigridPlan``).
    """
    if mesh is not None or replicate_below is not None:
        raise NotImplementedError(
            "the distributed multigrid cycle (mesh=, replicate_below=) is "
            "not ported yet: ROADMAP queue 1, item 8"
        )
    if levels is None:
        levels = 1
        n = nsize
        while n % 2 == 0 and n > 16:
            n //= 2
            levels += 1
    sizes = [nsize // (2 ** l) for l in range(levels)]
    for l, n in enumerate(sizes):
        if l > 0 and sizes[l - 1] != 2 * n:
            raise ValueError(
                f"nsize={nsize} not divisible by 2**{levels - 1}"
            )

    smoother = chebyshev_stencil_preconditioner(
        lam_max / smooth_band, lam_max, order=max(pre_smooth, 1),
    )
    post_smoother = chebyshev_stencil_preconditioner(
        lam_max / smooth_band, lam_max, order=max(post_smooth, 1),
    )
    # coarsest level's exact λ_min: solve its full spectrum
    lam_min_coarse = 8.0 * math.sin(math.pi / (2 * (sizes[-1] + 1))) ** 2
    coarse_solve = chebyshev_stencil_preconditioner(
        lam_min_coarse, lam_max, order=coarse_order,
    )

    def v_cycle(r: torch.Tensor, level: int) -> torch.Tensor:
        if level == levels - 1:
            return coarse_solve(r)
        e = smoother(r)
        ec = v_cycle(residual_restrict(r, e), level + 1)
        e, r3 = correct_residual(r, e, ec)
        return e + post_smoother(r3)

    def m_inv(r: torch.Tensor) -> torch.Tensor:
        return v_cycle(r, 0)

    # An order-k semi-iteration applies the stencil k−1 times; each
    # non-coarsest level adds 2 residual stencils; level l carries 4^-l of
    # the fine grid's points.
    per_level = (max(pre_smooth, 1) - 1) + (max(post_smooth, 1) - 1) + 2
    m_inv.fine_equiv_sweeps = sum(
        per_level * 0.25 ** l for l in range(levels - 1)
    ) + (coarse_order - 1) * 0.25 ** (levels - 1)
    m_inv.levels = levels
    m_inv.plan = MultigridPlan(
        sizes=tuple(sizes),
        pre_smooth=(smoother.theta, smoother.steps),
        post_smooth=(post_smoother.theta, post_smoother.steps),
        coarse=(coarse_solve.theta, coarse_solve.steps),
        lam_min_coarse=lam_min_coarse,
    )
    return m_inv
