"""The distributed V-cycles and the sparse operators on a sharded block of
rows, for tests/test_torch_halo_blocks.py: ``drive(mesh, cases, out)``,
which each rank of its gloo spawns (tests/torch_halo_worker.py:run_blocks)
runs after the halo routes' cases, drives on DTensors over the mesh of
every rank:

* every ``mesh=`` cycle (``replicate_below`` at its default and set so that
  a level is replicated) and the ``mesh=None`` Poisson cycle on a block of
  s grids placed ``[Shard(d + 1)]`` through ``ops/blas.py:row_apply``,
  beside each row's own call, the halo exchanges and collectives of each;
* ``sparse_operator`` of every format on a (s, n) block placed
  ``[Shard(1)]``, the same way;
* block CG with the ``mesh=`` Poisson cycle, LOBPCG with the ``mesh=None``
  cycle and block CG with cbpr2 on a HYB operator, on sharded blocks.

Keys ending ``_blk`` hold the rank's block along axis 1, every other key
a value equal on every rank. This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from tests.torch_dist_models_worker import _comm, _place
from tests.torch_dist_sparse_worker import matrices

N = 32        # the 2-D cycles' grid side, float64
N_3D = 8      # the 3-D cycle's cube side
KH2 = 0.3     # the Helmholtz cycles' k²h²
BELOW = {"default": (None, None), "replicated": (N, 2 * N_3D)}
# The cycles, by name: (block in ``cases``, the block's grid-row axis).
CYCLES = {"poisson": ("r", 1), "convdiff_chebyshev": ("r", 1), "convdiff_jacobi": ("r", 1),
          "convdiff_rbgs": ("r", 1), "helmholtz": ("r", 1), "csl_split": ("r_split", 2),
          "csl_complex": ("r_complex", 1), "poisson3d": ("r3", 1)}


def sparse_matrices(cases: dict) -> dict:
    """tests/torch_dist_sparse_worker.py's formats, with a wide-band DIA of
    five diagonals (offsets 0, ±1, ±200: a band wider than a rank's rows on
    two ranks or more) in place of its scattered one."""
    from gmres_tpu_torch.ops import sparse as sp

    out = matrices(cases["sparse"])
    out["dia_wide"] = sp.dia_from_dense(cases["wide_band"], device="cpu")
    return out


def cycle(name: str, mesh, below: int | None):
    """The port's ``mesh=`` cycle ``name`` (mesh None: its ``mesh=None``
    cycle) with ``replicate_below=below``."""
    import gmres_tpu_torch as tt

    kw = {"mesh": mesh, "replicate_below": below}
    if name == "poisson":
        return tt.poisson_multigrid_preconditioner(N, **kw)
    if name.startswith("convdiff_"):
        return tt.convection_diffusion_multigrid_preconditioner(
            N, 0.4, 0.2, smoother=name[len("convdiff_"):], **kw)
    if name == "helmholtz":
        return tt.helmholtz_shifted_laplacian_preconditioner(N, KH2, **kw)
    if name.startswith("csl_"):
        return tt.csl_multigrid_preconditioner(N, KH2, layout=name[len("csl_"):], **kw)
    return tt.poisson3d_multigrid_preconditioner(N_3D, **kw)


def drive(mesh, cases: dict, out: dict) -> None:
    """Every case of this module on ``mesh``, its outputs into ``out``;
    gmres_tpu's Arnoldi probe stands in for the port's while the
    convection–diffusion cycles are built, so that the Chebyshev smoother's
    intervals are gmres_tpu's."""
    import gmres_tpu_torch as tt
    from gmres_tpu_torch.precond import multigrid

    probe = multigrid._ritz_probe
    multigrid._ritz_probe = lambda m: torch.as_tensor(cases["probes"][m])
    try:
        for name, (key, dim) in CYCLES.items():
            for setting, belows in BELOW.items():
                m = cycle(name, mesh, belows[name == "poisson3d"])
                out[f"{name}_{setting}_levels"] = np.array([m.replicate_from, m.levels])
                _block(out, f"{name}_{setting}", m, cases[key], mesh, dim)
    finally:
        multigrid._ritz_probe = probe
    _block(out, "poisson_none", cycle("poisson", None, None), cases["r"], mesh, 1)
    for name, a in sparse_matrices(cases).items():
        _block(out, f"sparse_{name}", tt.sparse_operator(a), cases["x_flat"], mesh, 1)
    _solvers(mesh, cases, out)


def _block(out: dict, key: str, fn, blk: np.ndarray, mesh, dim: int) -> None:
    """fn on the block placed ``[Shard(dim)]`` through ``row_apply`` and on
    each row placed ``[Shard(dim - 1)]``: the block's rank rows (along axis
    1), its placements, its (exchanges, all-gathers, collectives) and the
    first row's, and whether each row is bitwise its own call."""
    from torch.distributed.tensor.debug import CommDebugMode

    from gmres_tpu_torch.ops.blas import row_apply, takes_row_blocks
    from gmres_tpu_torch.parallel.halo import halo_exchange

    def counted(call):
        halo_exchange.exchanges = 0
        with CommDebugMode() as comm:
            res = call()
        return res, [halo_exchange.exchanges, *_comm(comm)[[0, 2]]]

    xb = _place(blk, mesh, dim)
    placed = [_place(b, mesh, dim - 1) for b in blk]
    y, block = counted(lambda: row_apply(fn, xb))
    first, row = counted(lambda: fn(placed[0]))
    rows = [first] + [fn(b) for b in placed[1:]]
    out[f"{key}_blk"] = np.moveaxis(y.to_local().numpy(), dim, 1)
    out[f"{key}_placements"] = np.asarray(str(tuple(y.placements)))
    out[f"{key}_marked"] = np.asarray(takes_row_blocks(fn))
    # (exchanges, all-gathers, collectives): the block's, then one row's.
    out[f"{key}_comm"] = np.array([block, row])
    out[f"{key}_bitwise"] = np.asarray(all(
        torch.equal(y.to_local()[i], r.to_local()) for i, r in enumerate(rows)))


def _solvers(mesh, cases: dict, out: dict) -> None:
    """Block CG with the ``mesh=`` Poisson cycle, LOBPCG (k 4) with the
    ``mesh=None`` cycle, and block CG with cbpr2 on the HYB operator, each
    on a block placed ``[Shard(1)]``."""
    import gmres_tpu_torch as tt

    res = tt.block_cg(tt.poisson_operator(N), _place(cases["B_cg"], mesh, 1), tol=1e-9,
                      M=cycle("poisson", mesh, None))
    out["block_cg_mg_x_blk"] = res.x.to_local().numpy()
    out["block_cg_mg_counts"] = np.array([res.iterations, res.status])
    res = tt.lobpcg(tt.poisson_operator(N), _place(cases["lobpcg_x0"], mesh, 1), tol=1e-8,
                    max_iterations=100, M=cycle("poisson", None, None))
    out["lobpcg_mg_eigenvalues"] = np.asarray(res.eigenvalues)
    out["lobpcg_mg_counts"] = np.array([res.iterations, res.status])
    op = tt.sparse_operator(sparse_matrices(cases)["hyb"])
    res = tt.block_cg(op, _place(cases["B_flat"], mesh, 1), tol=1e-9,
                      M=tt.chebyshev_preconditioner(op, 0.2, 8.2))
    out["block_cg_hyb_x_blk"] = res.x.to_local().numpy()
    out["block_cg_hyb_counts"] = np.array([res.iterations, res.status])
