"""Geometric multigrid V-cycle preconditioners for the 5-point stencil.

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

``convection_diffusion_multigrid_preconditioner`` is the counterpart of the
JAX cycle of the same name for the nonsymmetric convection-diffusion
stencil (``models/convection_diffusion.py``): per-level operators with the
cell-Péclet numbers doubled at each coarsening, upwind rediscretisation on
convection-dominated levels, and damped-Jacobi, ellipse-Chebyshev or
red-black Gauss-Seidel smoothing. Its kernels are the Poisson cycle's: K1
(the level operators and the two V-cycle forms, with the level's
coefficients) and K2 (the Jacobi and Chebyshev smoothers and the coarse
solve) on a CUDA tensor.

``poisson3d_multigrid_preconditioner`` (with ``restrict_sum3d`` and
``helmholtz_shifted_laplacian_preconditioner`` is the JAX SPD cycle for the
indefinite Helmholtz stencil (level shifts shift·kh2·4ˡ): K2 for its
smoothers and coarse solve, K1's two forms for its level residuals, as in
the Poisson cycle. ``csl_multigrid_preconditioner`` is the complex-shifted
cycle: plain torch complex arithmetic (``layout="complex"``), or the real
(2, N, N) stack whose neighbour stencils launch K1 (``layout="split"``).

With ``mesh=`` every cycle but the anisotropic and varcoef ones (which
gmres_tpu gives none) runs on sharded grids (``_distributed_cycle``; the
``mesh=None`` Poisson, convection–diffusion and Helmholtz SPD cycles run it
on the mesh of a DTensor they are handed, ``_on_the_operands_mesh``): the
levels at or above ``replicate_below`` rows stay sharded, on halo forms —
K1's halo form for the Poisson, convection–diffusion and Helmholtz SPD
levels and their smoothers' recurrences, the plain complex form for the
complex CSL cycle, two K1 halo-form launches per level stencil of the
split CSL stack (sharded along its rows, dimension 1), the plain 7-point
form with whole halo planes for the 3-D cycle — and one all-gather a
cycle gives every rank the first level below, which the ``mesh=None``
cycle solves whole (K1's forms and K2 where it has them). JAX's GSPMD
makes the same split with sharding constraints. A block of s rows of a
sharded grid (``ops/blas.py:row_apply``, what ``jax.vmap`` makes of the
cycle) runs the cycle once on the rank's (s, …) block: the exchanges and
the all-gather of one row's cycle, each kernel launched once for the s
rows.

``poisson3d_multigrid_preconditioner`` (with ``restrict_sum3d`` and
``prolong_repeat3d``) is the JAX 3-D cycle for the 7-point stencil, plain
PyTorch on any device as the JAX cycle is plain jnp (neither package has a
3-D kernel). ``anisotropic_multigrid_preconditioner`` is the JAX cycle for
ε·u_xx + u_yy with line relaxation by PCR (``ops/tridiag.py``, plain
PyTorch) or point relaxation; its operator applications launch K1 on a
CUDA tensor (``models/anisotropic.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch
import torch.distributed as dist

from gmres_tpu_torch.models.convection_diffusion import (
    convection_diffusion_coefs,
    convection_diffusion_coefs_upwind,
)
from gmres_tpu_torch.ops.fused import (
    jacobi_k_scalars,
    poly_recurrence,
    poly_stencil_smoother_pallas,
)
from gmres_tpu_torch.ops.stencil import (  # noqa: F401  (transfers re-exported)
    POISSON_COEFS,
    correct_residual,
    prolong_repeat,
    residual_restrict,
    restrict_sum,
    stencil_5pt_general,
    stencil_5pt_halo,
    stencil_5pt_pallas_halo,
    stencil_5pt_routed_general,
)
from gmres_tpu_torch.models.helmholtz import split_laplacians
from gmres_tpu_torch.ops.blas import dtensor_of, on_local, row_blocks
from gmres_tpu_torch.precond.chebyshev import chebyshev_stencil_preconditioner
from gmres_tpu_torch.solvers.lanczos import (
    arnoldi_ritz_values,
    chebyshev_ellipse_interval,
    jacobi_omega_from_ritz,
)


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


def _replicate_from(sizes, mesh, replicate_below) -> int:
    """The first level of a distributed cycle that every rank holds whole:
    the first grid below ``replicate_below`` (default 8 rows a rank, as in
    JAX), or earlier where a rank's block of the level above has an odd row
    count. JAX's GSPMD reshards a transfer that straddles ranks; here a
    level stays sharded only while restricting the blocks above it is local
    (even rows a rank), and the first level where it would not be is
    agglomerated instead. Agglomeration moves data, not arithmetic, so the
    cycle is the same operator either way. ``len(sizes)`` where no level
    is replicated."""
    d = mesh.size()
    if replicate_below is None:
        replicate_below = 8 * d
    for l, sz in enumerate(sizes):
        if sz < replicate_below or (l > 0 and sizes[l - 1] % (2 * d)):
            return l
    return len(sizes)


def _distributed_cycle(mesh, sizes, replicate_from, local_apply, smooth_local,
                       plain_v_cycle, internal_dtype=None,
                       transfers=(restrict_sum, prolong_repeat), dim=0) -> Callable:
    """The V-cycle on grids sharded along ``dim`` (0: the rows of a 2-D
    grid or the planes of a 3-D one; 1: the rows of a (2, N, N) split
    stack): one ``local_map`` over each rank's block, so no DTensor
    operation can gather behind the cycle's back.

    Levels above ``replicate_from`` stay sharded: their operator is
    ``local_apply(x, l, halo)``, a halo form on the block whose ``halo(x)``
    exchanges the block's first and last slices along ``dim`` with the
    neighbouring ranks (``parallel/halo.py:_halo_rows``; K1's halo form on
    the card for a real 5-point level), their smoothers
    ``smooth_local(r, l, kind, apply)`` (kind "pre", "post" or "coarse")
    run over the same operator, and the ``transfers`` (restriction,
    prolongation) are local (the blocks hold even rows). At
    ``replicate_from`` one ``all_gather_into_tensor`` of the residual along
    ``dim`` gives every rank the whole grid, which ``plain_v_cycle(r,
    level)`` (the ``mesh=None`` cycle from that level down, routed by
    device) solves with no communication; the hand-back up is this rank's
    slice of it. ``internal_dtype`` runs the cycle in that dtype, as the
    plain cycles do.

    The block form (``parallel/halo.py:BlockSharded``: ``ops/blas.py:
    row_apply`` over s rows placed ``[Shard(dim + 1)]``, what gmres_tpu's
    ``jax.vmap`` makes of its cycle) runs the same cycle once on the rank's
    (s, …) block: the local forms, smoothers and transfers take the lanes
    first, a sharded-level application is one exchange along ``dim + 1``
    for the s rows (one lane launch of K1's halo form on the card), the
    replicated level one all-gather of the whole block, and the
    ``mesh=None`` cycle below it runs once under ``torch.func.vmap`` on the
    s gathered grids (one batched launch of each kernel a step). Each row
    gets the bits of its own call."""
    from gmres_tpu_torch.parallel.halo import BlockSharded, _halo_rows, _neighbours
    from gmres_tpu_torch.parallel.mesh import GRID_AXIS

    group = mesh.get_group(GRID_AXIS)
    neighbours = _neighbours(group)
    n_ranks, me = dist.get_world_size(group), dist.get_rank(group)
    n_levels = len(sizes)
    restrict, prolong = transfers

    def cycle(r, l, lanes):
        d = dim + lanes  # the grid-row axis, after the lanes' axis
        if l == replicate_from:
            rows = r.shape[d]
            part = r.movedim(d, 0).contiguous()
            whole = torch.empty((rows * n_ranks,) + tuple(part.shape[1:]), dtype=r.dtype,
                                device=r.device)
            # Not all_gather_single, its newer name: torch 2.11 lacks it.
            dist.all_gather_into_tensor(whole, part, group=group)
            whole = whole.movedim(0, d).contiguous()
            if lanes:
                z = torch.func.vmap(lambda t: plain_v_cycle(t, l))(whole)
            else:
                z = plain_v_cycle(whole, l)
            return z.narrow(d, me * rows, rows).contiguous()

        def apply(x):
            return local_apply(x, l, lambda t: _halo_rows(t, group, neighbours, d))

        if l == n_levels - 1:
            return smooth_local(r, l, "coarse", apply)
        e = smooth_local(r, l, "pre", apply)
        ec = cycle(restrict(r - apply(e)), l + 1, lanes)
        e = e + prolong(ec)
        return e + smooth_local(r - apply(e), l, "post", apply)

    def on(lanes):
        def m_inv_local(blk):
            if internal_dtype is not None and blk.dtype != internal_dtype:
                return cycle(blk.to(internal_dtype), 0, lanes).to(blk.dtype)
            return cycle(blk, 0, lanes)

        return m_inv_local

    m_inv = BlockSharded(mesh, on(False), on(True), dim)
    m_inv.replicate_from = replicate_from
    return m_inv


def _on_the_operands_mesh(m_inv: Callable, distributed: Callable) -> Callable:
    """A ``mesh=None`` cycle: ``m_inv`` on a plain r; on a DTensor r, the
    distributed cycle ``distributed(mesh)`` of the mesh r carries, built once
    per mesh (``parallel/halo.py:sharded_apply``: ``[Shard(0)]`` on a 1-D
    mesh, evenly; ``[Replicate()]`` takes ``m_inv`` on the local tensor).
    So a DTensor never reaches a kernel wrapper, and the one all-gather an
    application is the cycle's own, at its first replicated level. A block
    of rows of a row-sharded grid takes the distributed cycle's block form
    (one exchange a sharded-level application and one all-gather for the
    rows); so the cycle is marked as taking it whole
    (``ops/blas.py:row_blocks``)."""
    from gmres_tpu_torch.parallel.halo import sharded_apply

    cycles: dict = {}

    @row_blocks
    def apply(r: torch.Tensor) -> torch.Tensor:
        if dtensor_of(r) is None:
            return m_inv(r)
        return sharded_apply(r, cycles, distributed, m_inv)

    return apply


def _stencil_levels(level_coefs) -> Callable:
    """``_distributed_cycle``'s ``local_apply`` for real 5-point levels with
    coefficients ``level_coefs[l]``: K1's halo form on a CUDA block, one
    launch for a (s, rows, N) block of s rows with their (s, 1, N) halo
    rows."""
    def local_apply(x, l, halo):
        return stencil_5pt_pallas_halo(x, *halo(x), level_coefs[l])

    return local_apply


def _default_levels(nsize: int, levels, floor: int = 16):
    """The level count (coarsen while even and above ``floor``, unless
    given) and each level's grid size; ValueError where nsize is not
    divisible by 2^(levels−1)."""
    if levels is None:
        levels = 1
        n = nsize
        while n % 2 == 0 and n > floor:
            n //= 2
            levels += 1
    sizes = [nsize // (2 ** l) for l in range(levels)]
    for l, n in enumerate(sizes):
        if l > 0 and sizes[l - 1] != 2 * n:
            raise ValueError(f"nsize={nsize} not divisible by 2**{levels - 1}")
    return levels, sizes


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
    mesh, replicate_below: the distributed cycle on row-sharded grids
      (``_distributed_cycle``): levels at or above ``replicate_below`` rows
      (default 8 a rank) stay sharded, the first below it is gathered once
      and solved whole on every rank. ``replicate_below`` without a mesh is
      ignored, as in JAX. The result is the ``mesh=None`` cycle's to
      rounding. The ``mesh=None`` cycle handed a row-sharded DTensor runs
      this distributed cycle on the DTensor's mesh (built once per mesh,
      ``replicate_below`` at its default; ``_on_the_operands_mesh``), as do
      the convection–diffusion and Helmholtz SPD cycles.

    The returned callable carries ``levels``, ``fine_equiv_sweeps`` (the
    fine-grid-equivalent stencil sweeps of one cycle) and ``plan``
    (a ``MultigridPlan``); with a mesh also ``replicate_from``, the first
    replicated level.
    """
    levels, sizes = _default_levels(nsize, levels)

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

    polys = {"pre": smoother, "post": post_smoother, "coarse": coarse_solve}

    def smooth_local(r, l, kind, apply):
        return poly_recurrence(r, polys[kind].theta, polys[kind].steps, apply)

    def distributed(mesh, below=None):
        return _distributed_cycle(
            mesh, sizes, _replicate_from(sizes, mesh, below),
            _stencil_levels([POISSON_COEFS] * levels), smooth_local, v_cycle)

    m_inv = (distributed(mesh, replicate_below) if mesh is not None
             else _on_the_operands_mesh(m_inv, distributed))

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


def _ritz_probe(m: int) -> torch.Tensor:
    """The (m, m) float64 CPU probe that seeds each level's Arnoldi spectrum
    estimate: standard normal from a torch.Generator seeded 0. (JAX draws
    its probe from PRNGKey(0), a stream torch cannot reproduce; the tests
    patch this function to hand the port JAX's probe.)"""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    return torch.randn((m, m), generator=gen, dtype=torch.float64)


def _level_ritz(levels, coefs) -> list:
    """Arnoldi Ritz values (16 steps) of each level's stencil on a ≤64²
    surrogate grid, on the host at setup: the stencil symbol's spectrum is
    nearly independent of the grid size above ~32 rows."""
    out = []
    for (sz, _, _, _), cf in zip(levels, coefs):
        out.append(arnoldi_ritz_values(
            lambda x, cf=cf: stencil_5pt_general(x, *cf),
            _ritz_probe(min(sz, 64)), steps=16))
    return out


def convection_diffusion_multigrid_preconditioner(
    nsize: int,
    gamma_x: float = 0.4,
    gamma_y: float = 0.2,
    pre_smooth: int = 3,
    post_smooth: int = 3,
    omega: float = 0.7,
    coarse_iters: int = 64,
    mesh=None,
    replicate_below: int | None = None,
    central_gamma_max: float = 0.9,
    internal_dtype=None,
    max_levels: int | None = None,
    smoother: str = "jacobi",
    shift: float = 0.0,
    transpose: bool = False,
) -> Callable:
    """V-cycle preconditioner for the nonsymmetric convection-diffusion
    stencil (the arguments of the JAX function but ``use_pallas``, which
    has no counterpart: the tensor's device decides).

    Levels coarsen while the grid is even and above 16 rows (at most
    ``max_levels``); level l carries (γx·2ˡ, γy·2ˡ) and switches for good to
    the upwind stencil once max|γ| reaches ``central_gamma_max``. ``shift``
    adds σ·4ˡ to level l's centre coefficient (the cycle approximates
    (A + σI)⁻¹). ``transpose`` builds the exact transpose of the cycle: W↔E
    and S↔N swapped, the pre- and post-smoother counts swapped, the
    red-black parity flipped.

    smoother: "jacobi" (damped, ω/c₀ a step), "chebyshev" (the Manteuffel
      ellipse interval of each level's Arnoldi spectrum; ValueError where
      no level has one), "auto" (Chebyshev where a level has an interval,
      else Jacobi) or "rbgs" (red-black Gauss-Seidel on the levels where it
      contracts, else Jacobi). The coarse solve is ``coarse_iters`` steps
      of the level's smoother (Chebyshev on the full-spectrum interval).
    omega: the Jacobi damping, or "auto" for each level's from its spectrum.
    internal_dtype: run the whole cycle in this dtype (r cast on entry, z
      cast back on exit).
    mesh, replicate_below: the distributed cycle on row-sharded grids, as
      for ``poisson_multigrid_preconditioner``. A sharded level smooths with
      its own smoother over its halo operator: the Chebyshev polynomial,
      damped Jacobi in JAX's jnp form, or red-black sweeps whose colours
      come from the global row index (this rank's row offset added, where
      JAX's ``broadcasted_iota`` sees the global grid). The Ritz setup of
      "auto", "chebyshev" and ``omega="auto"`` runs at construction on
      plain host tensors, independent of r, so every rank has the same
      intervals.

    Routing: on a CUDA tensor the level operators and the two V-cycle
    compositions launch K1 with the level's coefficients, the Jacobi and
    Chebyshev smoothers and the coarse solve launch K2 (Jacobi as the
    order-k d-recurrence with (a, b) = (0, ω/c₀), JAX's TPU route), and the
    red-black sweeps are plain torch around K1. On a CPU tensor each piece
    takes JAX's CPU route: the plain compositions, and the Jacobi loop
    e = step·r, e ← e + step·(r − A e) (JAX's jnp form, which rounds
    differently from K2's r/θ start).

    The returned callable carries the JAX attributes ``levels``,
    ``level_schemes``, ``omegas``, ``smoothers``, ``cheb_intervals`` and
    ``coarse_interval``.
    """
    if smoother not in ("jacobi", "chebyshev", "auto", "rbgs"):
        raise ValueError(f"unknown smoother {smoother!r}")

    levels = []
    n, gx, gy = nsize, float(gamma_x), float(gamma_y)
    central = True
    while n % 2 == 0 and n > 16 and (
        max_levels is None or len(levels) < max_levels - 1
    ):
        levels.append((n, gx, gy, central))
        n, gx, gy = n // 2, 2 * gx, 2 * gy
        if max(abs(gx), abs(gy)) >= central_gamma_max:
            central = False
    levels.append((n, gx, gy, central))
    n_levels = len(levels)
    coefs = [
        convection_diffusion_coefs(g_x, g_y) if cen
        else convection_diffusion_coefs_upwind(g_x, g_y)
        for (_, g_x, g_y, cen) in levels
    ]
    if shift:
        # h²-scaled zeroth-order term: quadruples per coarsening.
        coefs = [(c0 + float(shift) * 4.0 ** l, cw, ce, cs, cn)
                 for l, (c0, cw, ce, cs, cn) in enumerate(coefs)]
    rb_parity = 0
    if transpose:
        coefs = [(c0, ce, cw, cn, cs) for (c0, cw, ce, cs, cn) in coefs]
        pre_smooth, post_smooth = post_smooth, pre_smooth
        rb_parity = 1

    ritz_list = None
    if omega == "auto" or smoother in ("chebyshev", "auto"):
        ritz_list = _level_ritz(levels, coefs)
    if omega == "auto":
        omegas = [jacobi_omega_from_ritz(ritz, cf[0]) for ritz, cf in zip(ritz_list, coefs)]
    else:
        omegas = [float(omega)] * n_levels

    # Ellipse-Chebyshev intervals: each level's high-frequency band, the
    # coarse solve's whole spectrum; None → damped Jacobi on that level.
    cheb_ivals = [None] * n_levels
    coarse_ival = None
    if smoother in ("chebyshev", "auto"):
        cheb_ivals = [chebyshev_ellipse_interval(r, band=4.0) for r in ritz_list]
        coarse_ival = chebyshev_ellipse_interval(ritz_list[-1], band=None)
        if smoother == "chebyshev" and all(iv is None for iv in cheb_ivals):
            raise ValueError(
                "smoother='chebyshev' infeasible: every level's "
                "high-frequency spectrum is taller than wide — use "
                "'auto' (per-level fallback to damped Jacobi)"
            )
    # Red-black Gauss-Seidel contracts only where the level's stencil is an
    # M-matrix: upwind levels, and central ones below the Péclet threshold.
    rbgs_ok = [(not cen) or max(abs(g_x), abs(g_y)) < central_gamma_max
               for (_, g_x, g_y, cen) in levels]

    def interval(l):
        return coarse_ival if l == n_levels - 1 else cheb_ivals[l]

    smoothers = [("rbgs" if rbgs_ok[l] else "jacobi") if smoother == "rbgs"
                 else ("chebyshev" if interval(l) is not None else "jacobi")
                 for l in range(n_levels)]

    # Each level's smoother applications, built once: (level, iterations).
    plans = {}
    for l in range(n_levels):
        for iters in ((coarse_iters,) if l == n_levels - 1
                      else (pre_smooth, post_smooth)):
            if smoothers[l] == "chebyshev":
                lo, hi = interval(l)
                plans[l, iters] = chebyshev_stencil_preconditioner(
                    lo, hi, order=iters, coefs=coefs[l])
            elif smoothers[l] == "jacobi":
                plans[l, iters] = jacobi_k_scalars(omegas[l], coefs[l][0], iters)
    masks = {}

    def apply_l(x, l):
        return stencil_5pt_routed_general(x, coefs[l])

    def jacobi(r, l, iters, apply=None):
        if r.device.type == "cpu" or apply is not None:
            apply = apply or (lambda x: apply_l(x, l))
            step = omegas[l] / coefs[l][0]
            e = step * r
            for _ in range(iters - 1):
                e = e + step * (r - apply(e))
            return e
        theta, steps = plans[l, iters]
        return poly_stencil_smoother_pallas(r, theta, steps, coefs[l])

    def rbgs(r, l, iters, apply=None, row0=0):
        # A sweep is the red update then the black one, each a masked Jacobi
        # step whose stencil reads only the other colour: exactly a
        # Gauss-Seidel iteration in checkerboard order. ``row0`` is the
        # global index of r's first row (a sharded level's block). The
        # masks are one grid's, broadcast over the lanes of a block of rows.
        apply = apply or (lambda x: apply_l(x, l))
        key = (tuple(r.shape[-2:]), row0, r.device)
        if key not in masks:
            ii = row0 + torch.arange(r.shape[-2], device=r.device)[:, None]
            jj = torch.arange(r.shape[-1], device=r.device)[None, :]
            red = ((ii + jj) % 2) == rb_parity
            masks[key] = (red, ~red)
        red, black = masks[key]
        c0 = coefs[l][0]

        def half(e, mask):
            resid = r - apply(e)
            return e + torch.where(mask, resid / c0, 0.0)

        # The first red half-step from e = 0 is the masked scaled r.
        e = half(torch.where(red, r / c0, 0.0), black)
        for _ in range(iters - 1):
            e = half(half(e, red), black)
        return e

    def smooth(r, l, iters):
        if smoothers[l] == "rbgs":
            return rbgs(r, l, iters)
        if smoothers[l] == "chebyshev":
            return plans[l, iters](r)
        return jacobi(r, l, iters)

    def v_cycle(r, l):
        if l == n_levels - 1:
            return smooth(r, l, coarse_iters)
        e = smooth(r, l, pre_smooth)
        ec = v_cycle(residual_restrict(r, e, coefs[l]), l + 1)
        e, r3 = correct_residual(r, e, ec, coefs[l])
        return e + smooth(r3, l, post_smooth)

    def m_inv(r: torch.Tensor) -> torch.Tensor:
        if internal_dtype is not None and r.dtype != internal_dtype:
            return v_cycle(r.to(internal_dtype), 0).to(r.dtype)
        return v_cycle(r, 0)

    def distributed(mesh, below=None):
        rank = dist.get_rank(mesh.get_group())

        def smooth_local(r, l, kind, apply):
            iters = {"pre": pre_smooth, "post": post_smooth, "coarse": coarse_iters}[kind]
            if smoothers[l] == "rbgs":
                return rbgs(r, l, iters, apply, row0=rank * r.shape[-2])
            if smoothers[l] == "chebyshev":
                poly = plans[l, iters]
                return poly_recurrence(r, poly.theta, poly.steps, apply)
            return jacobi(r, l, iters, apply)

        sizes = [sz for (sz, _, _, _) in levels]
        return _distributed_cycle(
            mesh, sizes, _replicate_from(sizes, mesh, below),
            _stencil_levels(coefs), smooth_local, v_cycle, internal_dtype)

    m_inv = (distributed(mesh, replicate_below) if mesh is not None
             else _on_the_operands_mesh(m_inv, distributed))

    m_inv.levels = n_levels
    m_inv.level_schemes = [("central" if cen else "upwind")
                           for (_, _, _, cen) in levels]
    m_inv.omegas = omegas
    m_inv.smoothers = smoothers
    m_inv.cheb_intervals = cheb_ivals
    m_inv.coarse_interval = coarse_ival
    return m_inv


def helmholtz_shifted_laplacian_preconditioner(
    nsize: int,
    kh2: float,
    shift: float = 1.0,
    levels: int | None = None,
    smooth_order: int = 3,
    coarse_order: int = 32,
    smooth_band: float = 4.0,
    mesh=None,
    replicate_below: int | None = None,
    use_pallas: str = "auto",
    internal_dtype=None,
) -> Callable:
    """SPD shifted-Laplacian V-cycle for the indefinite Helmholtz stencil
    (``models/helmholtz.py``): M ≈ (−Δ + shift·k²)⁻¹ (the arguments of the
    JAX function).

    Level l's stencil is (4 + shift·kh2·4ˡ, −1, −1, −1, −1) — the shift is
    an h²-scaled zeroth-order term, so it quadruples per coarsening — and
    its spectral interval is closed-form: the smoothers are order
    ``smooth_order`` Chebyshev on [λmax/band, λmax] with λmax = 8 + shift_l,
    the coarse solve order ``coarse_order`` over the coarsest level's whole
    spectrum. Pre- and post-smoother are the same fixed polynomial in the
    symmetric level operator and the transfers are adjoint, so the cycle
    is symmetric positive definite, as MINRES requires of M.

    Routing: the smoothers and the coarse solve are
    ``chebyshev_stencil_preconditioner`` with the level's coefficients (K2
    on a CUDA tensor; ``use_pallas="never"`` takes K2's plain version on any
    device), the level residuals K1's residual-restrict and correct-residual
    forms with the level's coefficients (their plain compositions on a CPU
    tensor, the JAX cycle's arithmetic). ``internal_dtype`` runs the cycle
    in that dtype (r cast on entry, z cast back). ``mesh`` and
    ``replicate_below`` give the distributed cycle on row-sharded grids, as
    for ``poisson_multigrid_preconditioner`` (its sharded levels smooth with
    the same polynomials over the level's halo operator).

    The returned callable carries ``levels``, ``level_shifts`` and
    ``fine_equiv_sweeps`` (and ``replicate_from`` with a mesh)."""
    if shift < 0:
        raise ValueError("shift must be >= 0 (SPD requires +k² shift)")
    levels, sizes = _default_levels(nsize, levels)
    shifts = [float(shift) * float(kh2) * 4.0 ** l for l in range(levels)]
    coefs = [(4.0 + s, -1.0, -1.0, -1.0, -1.0) for s in shifts]
    lam_maxs = [8.0 + s for s in shifts]
    lam_min_coarse = shifts[-1] + 8.0 * math.sin(math.pi / (2 * (sizes[-1] + 1))) ** 2
    smoother_at = [
        chebyshev_stencil_preconditioner(
            lam_maxs[l] / smooth_band, lam_maxs[l], order=max(smooth_order, 1),
            coefs=coefs[l], use_pallas=use_pallas)
        for l in range(levels)
    ]
    coarse = chebyshev_stencil_preconditioner(
        lam_min_coarse, lam_maxs[-1], order=coarse_order, coefs=coefs[-1],
        use_pallas=use_pallas)

    def v_cycle(r: torch.Tensor, level: int) -> torch.Tensor:
        if level == levels - 1:
            return coarse(r)
        s_l = smoother_at[level]
        e = s_l(r)
        ec = v_cycle(residual_restrict(r, e, coefs[level]), level + 1)
        e, r3 = correct_residual(r, e, ec, coefs[level])
        return e + s_l(r3)

    def m_inv(r: torch.Tensor) -> torch.Tensor:
        if internal_dtype is not None and r.dtype != internal_dtype:
            return v_cycle(r.to(internal_dtype), 0).to(r.dtype)
        return v_cycle(r, 0)

    def smooth_local(r, l, kind, apply):
        poly = coarse if kind == "coarse" else smoother_at[l]
        return poly_recurrence(r, poly.theta, poly.steps, apply)

    def distributed(mesh, below=None):
        return _distributed_cycle(
            mesh, sizes, _replicate_from(sizes, mesh, below),
            _stencil_levels(coefs), smooth_local, v_cycle, internal_dtype)

    m_inv = (distributed(mesh, replicate_below) if mesh is not None
             else _on_the_operands_mesh(m_inv, distributed))

    # Order-k Chebyshev = k−1 operator applications; 2 residual stencils a
    # non-coarsest level; level l carries 4^-l of the fine grid's points.
    per_level = 2 * (max(smooth_order, 1) - 1) + 2
    m_inv.fine_equiv_sweeps = sum(
        per_level * 0.25 ** l for l in range(levels - 1)
    ) + (coarse_order - 1) * 0.25 ** (levels - 1)
    m_inv.levels = levels
    m_inv.level_shifts = shifts
    return m_inv


def csl_multigrid_preconditioner(
    nsize: int,
    kh2: float,
    shift: tuple = (1.0, 0.5),
    levels: int | None = None,
    pre_smooth: int = 2,
    post_smooth: int = 2,
    omega: float = 0.5,
    coarse_iters: int = 32,
    mesh=None,
    replicate_below: int | None = None,
    layout: str = "complex",
) -> Callable:
    """Complex shifted-Laplacian V-cycle for the Helmholtz stencil:
    M ≈ (−Δ − (β₁ + iβ₂)k²)⁻¹ with shift = (β₁, β₂), the
    Erlangga–Oosterlee–Vuik preconditioner (the arguments of the JAX
    function).

    Level l's stencil is (4 − (β₁+iβ₂)·kh2·4ˡ, −1, −1, −1, −1); smoothing
    is damped Jacobi e ← e + ω/c₀·(r − A e) with the complex c₀
    (``coarse_iters`` sweeps on the coarsest level), and the transfers are
    ``restrict_sum``/``prolong_repeat``.

    layout="complex": a complex-to-complex callable, plain torch complex
    arithmetic on any device (K1 and K2 are real-only; gmres_tpu's cycle
    is plain jnp). Use it with ``gmres(..., variant="mgsr")`` on
    ``helmholtz_operator(n, kh2, damping=...)``.

    layout="split": the same cycle on the real (2, N, N) stack of
    ``helmholtz_split_operator``, every complex scalar multiply expanded to
    its 2×2 rotation; the neighbour stencils (0, −1, −1, −1, −1) of the two
    real planes run through K1 on a CUDA tensor (the plain stencil on a CPU
    one), the rotations and the Jacobi updates in torch.

    ``mesh`` and ``replicate_below`` give the distributed cycle
    (``_distributed_cycle``), as for ``poisson_multigrid_preconditioner``:
    a complex r row-sharded (``[Shard(0)]``), a split stack sharded along its
    rows (``[Shard(1)]``, gmres_tpu's ``P(None, "grid", None)``). A sharded
    level's stencil is one exchange and the complex halo form (plain torch)
    or, split, one exchange of both planes' rows and two K1 halo-form
    launches; the damped Jacobi steps run on the rank's block. Any other
    layout raises ValueError. The returned callable carries ``levels``,
    ``level_coefs`` and ``fine_equiv_sweeps`` (and ``replicate_from`` with a
    mesh)."""
    if layout not in ("complex", "split"):
        raise ValueError(f"unknown layout {layout!r}")
    beta = complex(float(shift[0]), float(shift[1]))
    levels, sizes = _default_levels(nsize, levels)
    coefs = [(4.0 - beta * float(kh2) * 4.0 ** l, -1.0, -1.0, -1.0, -1.0)
             for l in range(levels)]

    if layout == "split":
        nb_coefs = (0.0, -1.0, -1.0, -1.0, -1.0)

        # The planes are the third axis from the end, so that a (s, 2, rows,
        # N) block of s stacks takes the same expressions.
        def cmul(c, z):
            zr, zi = z.select(-3, 0), z.select(-3, 1)
            return torch.stack([c.real * zr - c.imag * zi, c.imag * zr + c.real * zi],
                               dim=-3)

        def apply_l(x, l):
            nb = torch.stack([stencil_5pt_routed_general(x[0], nb_coefs),
                              stencil_5pt_routed_general(x[1], nb_coefs)])
            return cmul(coefs[l][0], x) + nb

        def local_apply(x, l, halo):
            return cmul(coefs[l][0], x) + torch.stack(
                split_laplacians(x, *halo(x), nb_coefs), dim=-3)

        def scale_step(l, v):
            return cmul(omega / coefs[l][0], v)
    else:
        def apply_l(x, l):
            return stencil_5pt_general(x, *coefs[l])

        def local_apply(x, l, halo):
            return stencil_5pt_halo(x, *halo(x), coefs[l])

        def scale_step(l, v):
            return (omega / coefs[l][0]) * v

    def smooth(r, l, iters, apply=None):
        apply = apply or (lambda x: apply_l(x, l))
        e = scale_step(l, r)
        for _ in range(iters - 1):
            e = e + scale_step(l, r - apply(e))
        return e

    def v_cycle(r, l):
        if l == levels - 1:
            return smooth(r, l, coarse_iters)
        e = smooth(r, l, pre_smooth)
        # The transfers act on the last two axes: each plane of a split
        # stack, each lane of a block of rows.
        rc = restrict_sum(r - apply_l(e, l))
        e = e + prolong_repeat(v_cycle(rc, l + 1))
        return e + smooth(r - apply_l(e, l), l, post_smooth)

    def m_inv(r: torch.Tensor) -> torch.Tensor:
        return v_cycle(r, 0)

    if mesh is not None:
        iters = {"pre": pre_smooth, "post": post_smooth, "coarse": coarse_iters}

        def smooth_local(r, l, kind, apply):
            return smooth(r, l, iters[kind], apply)

        m_inv = _distributed_cycle(
            mesh, sizes, _replicate_from(sizes, mesh, replicate_below), local_apply,
            smooth_local, v_cycle, dim=1 if layout == "split" else 0)

    per_level = (pre_smooth - 1) + (post_smooth - 1) + 4
    m_inv.fine_equiv_sweeps = sum(
        per_level * 0.25 ** l for l in range(levels - 1)
    ) + (coarse_iters - 1) * 0.25 ** (levels - 1)
    m_inv.levels = levels
    m_inv.level_coefs = coefs
    return m_inv


def restrict_sum3d(x: torch.Tensor) -> torch.Tensor:
    """(2m,)³ → (m,)³ by 2×2×2 block sum × 1/2 (the 3-D consistency
    factor: the h²-scaled operator gains 4 per coarsening while a block
    holds 8 cells), summed axis by axis in the JAX order."""
    y = x[..., 0::2, :, :] + x[..., 1::2, :, :]
    y = y[..., 0::2, :] + y[..., 1::2, :]
    return 0.5 * (y[..., 0::2] + y[..., 1::2])


def prolong_repeat3d(x: torch.Tensor) -> torch.Tensor:
    """(m,)³ → (2m,)³ by replication (adjoint of ``restrict_sum3d`` up to
    its factor). Both transfers act on the last three axes, so a (s, …)
    block of s grids transfers each."""
    return (x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
            .repeat_interleave(2, dim=-1))


def poisson3d_multigrid_preconditioner(
    nsize: int,
    levels: int | None = None,
    pre_smooth: int = 3,
    post_smooth: int = 3,
    coarse_order: int = 32,
    smooth_band: float = 4.0,
    mesh=None,
    replicate_below: int | None = None,
) -> Callable:
    """V-cycle preconditioner for the 3-D 7-point Poisson stencil
    (``models/poisson3d.py``; the arguments of the JAX function): Chebyshev
    smoothing on [λmax/band, λmax] with λmax = 12, the closed-form coarse
    λmin, ``restrict_sum3d``/``prolong_repeat3d``. Levels coarsen while the
    grid is even and above 8 (nsize must be divisible by 2^(levels−1)).

    mesh, replicate_below: the distributed cycle on grids sharded along
      their first axis (``_distributed_cycle``, gmres_tpu's
      ``P("grid", None, None)``): a sharded level exchanges whole planes
      with its neighbours and applies ``stencil_7pt_halo``, its smoothers
      the same semi-iteration around it; the first level below
      ``replicate_below`` (default 8 a rank) is gathered once a cycle and
      solved whole.

    Plain PyTorch on the tensor's device: the smoothers are
    ``chebyshev_preconditioner``'s semi-iteration around
    ``stencil_7pt_apply``. The returned callable carries ``levels`` and
    ``fine_equiv_sweeps`` (and ``replicate_from`` with a mesh)."""
    from gmres_tpu_torch.ops.stencil import stencil_7pt_apply, stencil_7pt_halo
    from gmres_tpu_torch.precond.chebyshev import chebyshev_preconditioner

    levels, sizes = _default_levels(nsize, levels, floor=8)
    lam_max = 12.0
    lam_min_coarse = 6.0 * (1.0 - math.cos(math.pi / (sizes[-1] + 1)))
    pre = chebyshev_preconditioner(stencil_7pt_apply, lam_max / smooth_band, lam_max,
                                   order=max(pre_smooth, 1), reference_form=False)
    post = chebyshev_preconditioner(stencil_7pt_apply, lam_max / smooth_band, lam_max,
                                    order=max(post_smooth, 1), reference_form=False)
    coarse = chebyshev_preconditioner(stencil_7pt_apply, lam_min_coarse, lam_max,
                                      order=coarse_order, reference_form=False)

    def v_cycle(r, l):
        if l == levels - 1:
            return coarse(r)
        e = pre(r)
        rc = restrict_sum3d(r - stencil_7pt_apply(e))
        e = e + prolong_repeat3d(v_cycle(rc, l + 1))
        return e + post(r - stencil_7pt_apply(e))

    def m_inv(r: torch.Tensor) -> torch.Tensor:
        return v_cycle(r, 0)

    if mesh is not None:
        polys = {"pre": (lam_max / smooth_band, lam_max, max(pre_smooth, 1)),
                 "post": (lam_max / smooth_band, lam_max, max(post_smooth, 1)),
                 "coarse": (lam_min_coarse, lam_max, coarse_order)}

        def smooth_local(r, l, kind, apply):
            lo, hi, order = polys[kind]
            return chebyshev_preconditioner(apply, lo, hi, order=order,
                                            reference_form=False)(r)

        m_inv = _distributed_cycle(
            mesh, sizes, _replicate_from(sizes, mesh, replicate_below),
            lambda x, l, halo: stencil_7pt_halo(x, *halo(x), 6.0), smooth_local, v_cycle,
            transfers=(restrict_sum3d, prolong_repeat3d))

    per_level = (max(pre_smooth, 1) - 1) + (max(post_smooth, 1) - 1) + 2
    m_inv.fine_equiv_sweeps = sum(
        per_level * 0.125 ** l for l in range(levels - 1)
    ) + (coarse_order - 1) * 0.125 ** (levels - 1)
    m_inv.levels = levels
    return m_inv


def anisotropic_multigrid_preconditioner(
    nsize: int,
    eps: float,
    pre_smooth: int = 2,
    post_smooth: int = 2,
    omega: float = 0.8,
    coarse_iters: int = 32,
    min_size: int = 16,
    smoother: str = "line",
) -> Callable:
    """V-cycle for ε·u_xx + u_yy (``models/anisotropic.py``; the arguments
    of the JAX function). smoother="line" relaxes whole strong-axis lines,
    e ← e + ω T⁻¹(r − A e) with T = tridiag(−1, 2ε + 2, −1) solved by PCR
    along the last axis; smoother="point" is damped Jacobi,
    e ← e + ω/(2ε + 2)·(r − A e); anything else raises ValueError. The
    Poisson transfers carry over unchanged (the h²-scaled coefficients are
    level-independent); levels coarsen while the grid is even and above
    ``min_size``, and the coarsest runs ``coarse_iters`` sweeps.

    The line solves' elimination (``ops/tridiag.py:pcr_plan``) does not
    depend on the residual: it runs once per level size, dtype and device,
    on one row of coefficients that every line shares, and each sweep
    replays it (``pcr_apply``), the same arithmetic as JAX's
    ``tridiag_solve_pcr`` on full coefficient arrays.

    On a row-sharded r (a DTensor) the lines run along the unsharded last
    axis, so each rank solves its own rows with no message
    (``ops/blas.py:on_local``); the operator takes its DTensor route (one
    halo exchange an application); the restrictions are DTensor's own (two
    all-gathers at the first, the levels below replicated, where the
    operator takes the local tensor: K1 on the card). gmres_tpu gives this
    cycle no ``mesh=`` form, and the port keeps it so on either device; no
    kernel wrapper sees a DTensor."""
    from gmres_tpu_torch.models.anisotropic import anisotropic_apply
    from gmres_tpu_torch.ops.tridiag import pcr_apply, pcr_plan

    if smoother not in ("line", "point"):
        raise ValueError(f"unknown smoother {smoother!r}")

    sizes = [nsize]
    while sizes[-1] % 2 == 0 and sizes[-1] > min_size:
        sizes.append(sizes[-1] // 2)
    n_levels = len(sizes)
    diag = 2.0 * eps + 2.0
    plans = {}

    def line_solve(r):
        key = (r.shape[-1], r.dtype, r.device)
        if key not in plans:
            full = functools.partial(torch.full, (r.shape[-1],), dtype=r.dtype,
                                     device=r.device)
            plans[key] = pcr_plan(full(-1.0), full(diag), full(-1.0))
        return on_local(lambda t: pcr_apply(plans[key], t), r)

    def smooth(r, iters):
        e = torch.zeros_like(r)
        for _ in range(iters):
            resid = r - anisotropic_apply(e, eps)
            if smoother == "line":
                e = e + omega * line_solve(resid)
            else:
                e = e + (omega / diag) * resid
        return e

    def v_cycle(r, l):
        if l == n_levels - 1:
            return smooth(r, coarse_iters)
        e = smooth(r, pre_smooth)
        resid = r - anisotropic_apply(e, eps)
        e = e + prolong_repeat(v_cycle(restrict_sum(resid), l + 1))
        resid = r - anisotropic_apply(e, eps)
        return e + smooth(resid, post_smooth)

    def m_inv(r: torch.Tensor) -> torch.Tensor:
        return v_cycle(r, 0)

    return m_inv
