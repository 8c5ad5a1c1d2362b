"""One rank of the port's distributed explicit-halo path, for
tests/test_torch_halo.py, and of its scaling programs, for
tests/test_torch_cli.py (``run_cli``).

``run(rank, world, init_file, out_dir, cases)`` joins a gloo process group
of ``world`` CPU processes through ``init_multihost`` (rendezvous on
``init_file``), which returns the port's mesh over every rank, and drives
every case on row-sharded DTensors, on the explicit-halo route and on the
RDMA route. Each rank
writes its local blocks and its solvers' counts to
``out_dir/rank{rank}.npz``; the test assembles the blocks and holds them
against ``gmres_tpu`` in the parent process. This module imports no JAX,
so each spawned process starts with torch alone.
"""

from __future__ import annotations

import contextlib
import importlib
import os

import numpy as np
import torch
import torch.distributed as dist

from tests import torch_dist_blocks_worker


def run(rank: int, world: int, init_file: str, out_dir: str, cases: dict) -> None:
    import gmres_tpu_torch as tt

    torch.set_num_threads(1)
    mesh = tt.init_multihost(f"file://{init_file}", world, rank, device_type="cpu")
    try:
        _drive(rank, mesh, out_dir, cases)
    finally:
        dist.destroy_process_group()


def _local(t) -> np.ndarray:
    return t.to_local().numpy()


def _drive(rank: int, mesh, out_dir: str, cases: dict) -> None:
    import gmres_tpu_torch as tt

    out = {"mesh_shape": np.asarray(tuple(mesh.shape))}

    def shard(a):
        return tt.shard_grid_vector(torch.as_tensor(a), mesh)

    x = shard(cases["x"])
    _halo_rows_out(mesh, x.to_local(), out)
    out["y_poisson"] = _local(tt.halo_poisson_operator(mesh)(x))
    # A plain tensor is taken as this rank's block.
    out["y_poisson_plain_block"] = tt.halo_poisson_operator(mesh)(x.to_local()).numpy()
    out["y_general"] = _local(tt.halo_stencil_operator(mesh, cases["coefs"])(x))
    for order in (2, 4):
        m_inv = tt.halo_chebyshev_preconditioner(mesh, 0.2, 8.2, order=order)
        out[f"z_order{order}"] = _local(m_inv(x))

    op = tt.halo_poisson_operator(mesh)
    m_inv = tt.halo_chebyshev_preconditioner(mesh, 0.2, 8.2)
    b_cg = shard(cases["b_cg"])
    res = tt.cg(op, b_cg, tol=1e-9, max_iterations=2000, M=m_inv)
    out["cg_x"] = _local(res.x)
    out["cg_counts"] = np.array([res.iterations, res.status])
    out["cg_residual"] = np.asarray(float(res.residual))

    b_gm = shard(cases["b_gmres"])
    for ortho in ("cgs2", "mgs2"):
        res = tt.gmres(op, b_gm, restart=cases["restart"], tol=1e-10, M=m_inv,
                       max_restarts=100, variant="mgsr",
                       orthogonalization=ortho)
        out[f"gmres_{ortho}_x"] = _local(res.x)
        out[f"gmres_{ortho}_counts"] = np.array(
            [res.iterations, res.restarts, res.status])
        out[f"gmres_{ortho}_history"] = res.residual_history.numpy()
        out[f"gmres_{ortho}_v_err"] = res.v_err.numpy()
        out[f"gmres_{ortho}_x_is_sharded"] = np.asarray(
            tt.ops.blas.is_dtensor(res.x))

    _drive_rdma(mesh, shard, cases, out)

    res = tt.gmres(op, b_gm, restart=cases["restart"], tol=1e-10, M=m_inv,
                   max_restarts=100, variant="householder")
    out["gmres_householder_x"] = _local(res.x)
    out["gmres_householder_counts"] = np.array([res.iterations, res.restarts, res.status])

    out["mesh_error"] = np.asarray(_error(
        lambda: tt.solver_mesh(dist.get_world_size() + 1, device_type="cpu")))
    out["shard_error"] = np.asarray(_error(
        lambda: tt.shard_grid_vector(torch.zeros((31, 31)), mesh)))

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def _halo_rows_out(mesh, blk, out: dict) -> None:
    """This rank's halo rows two ways: ``halo_exchange`` (two rows, zeros
    where there is no neighbour) and the operators' ``_halo_rows`` (None
    there, written as NaN), each as a (1, 2N) row."""
    import gmres_tpu_torch as tt
    from gmres_tpu_torch.parallel.halo import _halo_rows, _neighbours

    group = mesh.get_group("grid")
    top, bottom = tt.halo_exchange(blk, group)
    out["halo_exchange_rows"] = torch.cat([top, bottom], dim=1).numpy()
    rows = _halo_rows(blk, group, _neighbours(group))
    out["halo_rows"] = np.concatenate(
        [np.full((1, blk.shape[1]), np.nan) if h is None else h.numpy() for h in rows],
        axis=1)


def _drive_rdma(mesh, shard, cases: dict, out: dict) -> None:
    """The RDMA route (ops/stencil_rdma.py): the operators in float32 (as
    the JAX kernel runs) and the Laplacian in float64, then MGSR GMRES with
    A and M on the route and CG on the operator, in float32."""
    import gmres_tpu_torch as tt
    from gmres_tpu_torch.ops import stencil_rdma
    from gmres_tpu_torch.parallel.halo import (
        rdma_chebyshev_preconditioner,
        rdma_stencil_operator,
    )

    group = mesh.get_group("grid")
    x32 = shard(cases["x"].astype(np.float32))
    op = rdma_stencil_operator(mesh)
    m_inv = rdma_chebyshev_preconditioner(mesh, 0.2, 8.2)
    out["rdma_poisson"] = _local(op(x32))
    out["rdma_poisson_f64"] = _local(op(shard(cases["x"])))
    out["rdma_asym"] = _local(rdma_stencil_operator(mesh, cases["coefs_asym"])(x32))
    out["rdma_cbpr2"] = _local(m_inv(x32))
    # The same preconditioner on a float64 block: its coefficients rounded
    # anew for that dtype, once.
    out["rdma_cbpr2_f64"] = _local(m_inv(shard(cases["x"])))
    # The public per-call entry, which rounds and finds the neighbours itself.
    out["rdma_public_asym"] = stencil_rdma.stencil_5pt_rdma(
        x32.to_local(), (*cases["coefs_asym"], 0.0, 1.0), group).numpy()
    # The rows the route receives: None (NaN here) where there is no
    # neighbour, so an end rank corrects one row and a lone rank none.
    top, bottom, wait = stencil_rdma.post_halo_rows(
        x32.to_local(), group, stencil_rdma._neighbours(group))
    wait()
    out["rdma_rows"] = np.concatenate(
        [np.full((1, x32.shape[1]), np.nan) if h is None else h.numpy()
         for h in (top, bottom)], axis=1)
    # MGSR GMRES, here and in the JAX reference alike.
    res = tt.gmres(op, shard(cases["b_rdma_gmres"]), restart=30, tol=1e-5,
                   M=m_inv, max_restarts=10, variant="mgsr", compute_v_err=False)
    out["rdma_gmres_x"] = _local(res.x)
    out["rdma_gmres_counts"] = np.array([res.iterations, res.restarts, res.status])
    res = tt.cg(op, shard(cases["b_rdma_cg"]), tol=1e-4, max_iterations=500)
    out["rdma_cg_x"] = _local(res.x)
    out["rdma_cg_counts"] = np.array([res.iterations, res.status])


def _error(fn) -> str:
    """The message of the ValueError fn raises ("" if it raises none)."""
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def run_cli(rank: int, world: int, init_file: str, out_dir: str, runs: dict) -> None:
    """Drive the port's CLI programs on one rank of a gloo group of
    ``world`` processes, for tests/test_torch_cli.py. ``runs`` maps a label
    to an argv; each program's JSONL goes to ``out_dir/<label>.jsonl``
    (rank 0 writes it), and an exception it raised to
    ``out_dir/<label>.rank<rank>.err`` as "<type>: <message>"."""
    from gmres_tpu_torch.benchmarks.cli import main

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        for label, argv in runs.items():
            try:
                main(argv + ["--jsonl", os.path.join(out_dir, f"{label}.jsonl")])
            except Exception as exc:  # recorded for the test to inspect
                with open(os.path.join(out_dir, f"{label}.rank{rank}.err"), "w") as f:
                    f.write(f"{type(exc).__name__}: {exc}")
    finally:
        dist.destroy_process_group()


# The block form (tests/test_torch_halo_blocks.py): s rows of a row-sharded
# grid in one application.
N_BLOCK = 32       # the halo routes' block side, float64
N_RDMA_BLOCK = 16  # the RDMA routes' block side, float32 (N_RDMA_CG's)
N_3D = 8           # the 7-point stencil's cube side (a plain operator's halo form)
KH2 = 0.3          # the complex Helmholtz operator's k²h² (a complex halo form)
SPLIT_ROUTES = ("helmholtz_split",)  # (s, 2, N, N) stacks: rows on the third axis


def run_blocks(rank: int, world: int, init_file: str, out_dir: str, cases: dict) -> None:
    """One rank of tests/test_torch_halo_blocks.py: every halo-route
    operator on a (s, N, N) block placed ``[Shard(1)]`` through
    ``ops/blas.py:row_apply``, beside each row's own call, with the halo
    exchanges of each; then block CG and LOBPCG on a sharded block; then
    the distributed V-cycles and the sparse operators on sharded blocks
    (tests/torch_dist_blocks_worker.py). Keys ending ``_blk`` hold this
    rank's block along axis 1 (``assembled``)."""
    import gmres_tpu_torch as tt

    torch.set_num_threads(1)
    mesh = tt.init_multihost(f"file://{init_file}", world, rank, device_type="cpu")
    try:
        out = {}
        _drive_blocks(mesh, cases, out)
        _drive_block_solvers(mesh, cases, out)
        torch_dist_blocks_worker.drive(mesh, cases["cycle_blocks"], out)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def block_routes(mesh, cases: dict) -> dict:
    """{route: (operator, block)}: every halo-route operator of the port and
    the block it takes here (numpy), a block of s grids along its first
    axis; the split stack's grid rows are its third axis, every other
    block's its second (``SPLIT_ROUTES``)."""
    import gmres_tpu_torch as tt
    from gmres_tpu_torch.parallel.halo import (
        rdma_chebyshev_preconditioner,
        rdma_stencil_operator,
    )

    x, x32 = cases["blk"], cases["blk_rdma"]
    return {
        "poisson": (tt.halo_poisson_operator(mesh), x),
        "general": (tt.halo_stencil_operator(mesh, cases["coefs"]), x),
        "cbpr2": (tt.halo_chebyshev_preconditioner(mesh, 0.2, 8.2), x),
        "cheb4": (tt.halo_chebyshev_preconditioner(mesh, 0.2, 8.2, order=4), x),
        "plain_poisson": (tt.poisson_operator(N_BLOCK), x),
        "helmholtz_complex": (tt.helmholtz_operator(N_BLOCK, KH2, damping=0.2),
                              cases["blk_complex"]),
        "helmholtz_split": (tt.helmholtz_split_operator(N_BLOCK, KH2, damping=0.2),
                            cases["blk_split"]),
        "poisson3d": (tt.poisson3d_operator(N_3D), cases["blk_3d"]),
        "varcoef": (tt.varcoef_operator(torch.as_tensor(cases["c_varcoef"])), x),
        "rdma": (rdma_stencil_operator(mesh), x32),
        "rdma_asym": (rdma_stencil_operator(mesh, cases["coefs_asym"]), x32),
        "rdma_cbpr2": (rdma_chebyshev_preconditioner(mesh, 0.2, 8.2), x32),
    }


# The kernel entries of the halo route, by the module that calls each.
KERNEL_ENTRIES = (("gmres_tpu_torch.models.helmholtz", "stencil_5pt_pallas_halo"),
                  ("gmres_tpu_torch.parallel.halo", "stencil_5pt_pallas_halo"),
                  ("gmres_tpu_torch.parallel.halo", "cheb2_apply"),
                  ("gmres_tpu_torch.parallel.halo", "rdma_apply"))


@contextlib.contextmanager
def kernel_entries(calls: list):
    """Each call of a kernel entry of the halo route appends whether a
    ``torch.func.vmap`` level batches its block (on the card a batched
    block has no storage to launch on)."""
    from gmres_tpu_torch.ops import _cuda

    saved = []
    for module, name in KERNEL_ENTRIES:
        mod = importlib.import_module(module)
        entry = getattr(mod, name)

        def tapped(x, *args, entry=entry):
            calls.append(_cuda.vmapped(x))
            return entry(x, *args)

        saved.append((mod, name, entry))
        setattr(mod, name, tapped)
    try:
        yield
    finally:
        for mod, name, entry in saved:
            setattr(mod, name, entry)


def _drive_blocks(mesh, cases: dict, out: dict) -> None:
    """Each route's block application (its exchanges and kernel entry calls
    counted) beside the rows applied one by one (theirs counted), and
    whether every row is bitwise its own call."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from gmres_tpu_torch.ops.blas import row_apply
    from gmres_tpu_torch.parallel.halo import halo_exchange

    for name, (op, blk) in block_routes(mesh, cases).items():
        dim = 1 + (name in SPLIT_ROUTES)
        xb = distribute_tensor(torch.as_tensor(blk), mesh, [Shard(dim)])
        halo_exchange.exchanges = 0
        block_calls, row_calls = [], []
        with kernel_entries(block_calls):
            y = row_apply(op, xb)
        block_exchanges = halo_exchange.exchanges
        halo_exchange.exchanges = 0
        with kernel_entries(row_calls):
            rows = [op(distribute_tensor(torch.as_tensor(blk[i]), mesh, [Shard(dim - 1)]))
                    for i in range(blk.shape[0])]
        row_exchanges = halo_exchange.exchanges / blk.shape[0]
        # Kernel entry calls of the block, those on a batched block, a row's.
        out[f"{name}_entries"] = np.array([len(block_calls), sum(block_calls),
                                           len(row_calls) / blk.shape[0]])
        # The rank's rows along axis 1 (a split stack's moved there).
        out[f"{name}_blk"] = np.moveaxis(y.to_local().numpy(), dim, 1)
        out[f"{name}_placements"] = np.asarray(str(tuple(y.placements)))
        out[f"{name}_exchanges"] = np.array([block_exchanges, row_exchanges])
        out[f"{name}_bitwise"] = np.asarray(all(
            torch.equal(y.to_local()[i], r.to_local()) for i, r in enumerate(rows)))


def _drive_block_solvers(mesh, cases: dict, out: dict) -> None:
    """Block CG (the halo operator, the halo cbpr2) and LOBPCG (the halo
    operator, the halo cbpr2 as M) on blocks placed ``[Shard(1)]``."""
    import gmres_tpu_torch as tt
    from torch.distributed.tensor import Shard, distribute_tensor

    from gmres_tpu_torch.parallel.halo import halo_exchange

    op = tt.halo_poisson_operator(mesh)
    m = tt.halo_chebyshev_preconditioner(mesh, 0.2, 8.2)
    b = distribute_tensor(torch.as_tensor(cases["B_cg"]), mesh, [Shard(1)])
    halo_exchange.exchanges = 0
    res = tt.block_cg(op, b, tol=1e-9, M=m)
    out["block_cg_exchanges"] = np.asarray(halo_exchange.exchanges)
    out["block_cg_x_blk"] = res.x.to_local().numpy()
    out["block_cg_counts"] = np.array([res.iterations, res.status])
    x0 = distribute_tensor(torch.as_tensor(cases["lobpcg_x0"]), mesh, [Shard(1)])
    res = tt.lobpcg(op, x0, tol=1e-8, max_iterations=100, M=m)
    out["lobpcg_eigenvalues"] = np.asarray(res.eigenvalues)
    out["lobpcg_counts"] = np.array([res.iterations, res.status])
