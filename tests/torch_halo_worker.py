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

import os

import numpy as np
import torch
import torch.distributed as dist


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
