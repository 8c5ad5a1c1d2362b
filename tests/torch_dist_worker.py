"""One rank of the port's distributed solve, for tests/test_torch_dist.py.

``run(rank, world, init_file, out_dir, cases)`` joins a gloo process group
of ``world`` CPU processes through ``init_multihost`` (rendezvous on
``init_file``) and drives, on row-sharded DTensors over the mesh of every
rank: Householder GMRES, the GMRES family, block CG and s-step CG, the
short-recurrence and transpose solvers on the halo operators, and the three
``mesh=`` multigrid cycles (one application against the ``mesh=None``
cycle, and the solvers they precondition), with the collectives of a solve
counted by ``CommDebugMode`` and the halo exchanges by
``halo_exchange.exchanges``. Each rank writes ``out_dir/rank{rank}.npz``:
its row blocks of the solutions (2-D), its blocks of block solutions (keys
ending ``_blk``, 3-D) and every count and scalar (equal on every rank).
``weak-scaling --precond mg`` runs through the port's CLI in the same
group, its JSONL written by rank 0. This module imports no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

N_FAM = 48   # the GMRES family, block GMRES
N_MG = 64    # the cycles, CG/BiCGSTAB/MINRES with them, IDR(s), GCRO-DR, block CG
N_T = 32     # Householder with cbpr2, QMR/LSQR/LSMR, the Lanczos bounds


def run(rank: int, world: int, init_file: str, out_dir: str, cases: dict) -> None:
    import gmres_tpu_torch as tt

    torch.set_num_threads(1)
    mesh = tt.init_multihost(f"file://{init_file}", world, rank, device_type="cpu")
    try:
        out = {}
        _drive(mesh, cases, out)
        _cli(out_dir, cases)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _counts(res) -> np.ndarray:
    """(iterations, restarts, status) of a result (0 for a count it does not
    have)."""
    return np.array([getattr(res, "iterations", 0), getattr(res, "restarts", 0),
                     res.status])


def _drive(mesh, cases: dict, out: dict) -> None:
    import gmres_tpu_torch as tt
    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_coefs
    from gmres_tpu_torch.models.helmholtz import helmholtz_coefs
    from gmres_tpu_torch.solvers import idrs as tidrs

    def shard(a):
        return tt.shard_grid_vector(torch.as_tensor(a), mesh)

    def block(a):
        from torch.distributed.tensor import Shard, distribute_tensor

        return distribute_tensor(torch.as_tensor(a), mesh, [Shard(1)])

    def keep(key, res, blk=False):
        out[key + "_counts"] = _counts(res)
        x = res.x.to_local().numpy()
        out[key + ("_x_blk" if blk else "_x")] = x

    poisson = tt.halo_poisson_operator(mesh)
    cd = tt.halo_stencil_operator(mesh, convection_diffusion_coefs(0.4, 0.2))
    cbpr2 = tt.chebyshev_preconditioner(poisson, 0.2, 8.2)

    # Householder GMRES on a sharded b, with the orthogonality audit.
    res = tt.gmres(poisson, shard(cases["b_t"]), restart=12, tol=1e-10,
                   M=tt.halo_chebyshev_preconditioner(mesh, 0.2, 8.2),
                   variant="householder", max_restarts=200)
    keep("hh", res)
    out["hh_v_err"] = res.v_err.numpy()
    out["hh_history"] = res.residual_history.numpy()

    # The GMRES family (the arguments of gmres_tpu's sharded tests).
    b_fam = shard(cases["b_fam"])
    keep("fgmres", tt.fgmres(poisson, b_fam, restart=15, tol=1e-9, M=cbpr2,
                             max_restarts=100))
    keep("sstep_gmres", tt.sstep_gmres(
        poisson, b_fam, s=8, tol=1e-8,
        M=tt.chebyshev_preconditioner(poisson, 0.005, 8.0, order=16)))
    keep("lgmres", tt.lgmres(poisson, b_fam, restart=10, aug=3, tol=1e-8,
                             max_restarts=500))
    keep("gmres_dr", tt.gmres_dr(poisson, b_fam, restart=20, deflate=6, tol=1e-10,
                                 max_restarts=100))
    keep("block_gmres", tt.block_gmres(poisson, block(cases["B_gmres"]), restart=20,
                                       tol=1e-10, M=cbpr2, max_restarts=100), blk=True)
    b_cd = shard(cases["b_cd"])
    original = tidrs._shadow_block
    p = cases["idrs_shadow"]
    tidrs._shadow_block = lambda s_, shape, dtype, device: torch.as_tensor(p).to(dtype)
    try:
        keep("idrs", tt.idrs(cd, b_cd, s=4, tol=1e-9, max_iterations=3000))
    finally:
        tidrs._shadow_block = original
    keep("gcrodr", tt.gcrodr(cd, b_cd, k=6, restart=24, tol=1e-10, max_restarts=100))
    cd48 = tt.halo_stencil_operator(mesh, convection_diffusion_coefs(0.4, 0.2))
    keep("gcrodr_mixed", tt.gcrodr(cd48, shard(cases["b_cd48"]), k=4, restart=16,
                                   tol=1e-9, max_restarts=80, inner_dtype=torch.float32))

    # Block CG and s-step CG.
    res = tt.block_cg(poisson, block(cases["B_cg"]), tol=1e-9)
    keep("block_cg", res, blk=True)
    keep("sstep_cg", tt.sstep_cg(poisson, shard(cases["b_mg"]), s=4, tol=1e-10))

    # The transpose solvers through the halo operator's rules: on the
    # Poisson operator, and QMR and LSQR on the nonsymmetric
    # convection-diffusion one, whose transpose is the mirrored stencil.
    b_t, b_cdt = shard(cases["b_t"]), shard(cases["b_cdt"])
    rules = dict(tt.parallel.halo.HaloStencil.rule_applications)
    for name in ("qmr", "lsqr", "lsmr"):
        keep(name, getattr(tt, name)(poisson, b_t, tol=1e-8, max_iterations=2000))
    for name in ("qmr", "lsqr"):
        keep(f"{name}_cd", getattr(tt, name)(cd, b_cdt, tol=1e-8, max_iterations=2000))
    after = tt.parallel.halo.HaloStencil.rule_applications
    out["transposes"] = np.asarray(after["transpose"] - rules["transpose"])

    # Aᵀ·v and J·v of the convection-diffusion halo operator: vjp on the
    # sharded x; jvp on each rank's block (forward-mode AD makes no dual of
    # a DTensor: aten._has_same_storage_numel has no sharding rule).
    x, v = shard(cases["x_t"]), shard(cases["v_t"])
    out["cd_vjp"] = torch.func.vjp(cd, x)[1](v)[0].to_local().numpy()
    tangents = after["tangent"]
    out["cd_jvp"] = torch.func.jvp(cd, (x.to_local(),), (v.to_local(),))[1].numpy()
    out["tangents"] = np.asarray(
        tt.parallel.halo.HaloStencil.rule_applications["tangent"] - tangents)

    # The solvers that ran before: with the convection-diffusion mesh= cycle
    # (BiCGSTAB, CGS, TFQMR), unpreconditioned (BiCGStab(2)), MINRES with the
    # Helmholtz mesh= cycle, and the Lanczos bounds.
    cd_mg = tt.convection_diffusion_multigrid_preconditioner(N_MG, 0.4, 0.2, mesh=mesh)
    for name in ("bicgstab", "cgs", "tfqmr"):
        keep(name, getattr(tt, name)(cd, b_cd, tol=1e-9, max_iterations=200, M=cd_mg))
    keep("bicgstabl", tt.bicgstabl(cd, b_cd, ell=2, tol=1e-9, max_iterations=500))
    kh2 = cases["kh2"]
    hz = tt.halo_stencil_operator(mesh, helmholtz_coefs(kh2))
    hz_mg = tt.helmholtz_shifted_laplacian_preconditioner(N_MG, kh2, mesh=mesh)
    keep("minres", tt.minres(hz, shard(cases["b_hz"]), tol=1e-9, max_iterations=1000,
                             M=hz_mg))
    lo, hi = tt.lanczos_bounds(poisson, shard(cases["probe"]), steps=20)
    out["lanczos"] = np.array([float(lo), float(hi)])

    _cycles(mesh, cases, out)


def _cycles(mesh, cases: dict, out: dict) -> None:
    """One application of each mesh= cycle against its mesh=None cycle, the
    solves with the Poisson one, and what they communicate."""
    import gmres_tpu_torch as tt
    from torch.distributed.tensor.debug import CommDebugMode

    def shard(a):
        return tt.shard_grid_vector(torch.as_tensor(a), mesh)

    exchanges = tt.halo_exchange
    r = torch.as_tensor(cases["r"])
    kh2 = cases["kh2"]
    pairs = {
        "poisson": lambda **kw: tt.poisson_multigrid_preconditioner(N_MG, levels=4, **kw),
        "poisson_allsharded": lambda **kw: tt.poisson_multigrid_preconditioner(
            N_MG, levels=4, replicate_below=0 if kw else None, **kw),
        "poisson_replicated": lambda **kw: tt.poisson_multigrid_preconditioner(
            N_MG, levels=4, replicate_below=N_MG + 1 if kw else None, **kw),
        "helmholtz": lambda **kw: tt.helmholtz_shifted_laplacian_preconditioner(
            N_MG, kh2, levels=4, **kw),
    }
    for smoother in ("jacobi", "auto", "rbgs"):
        pairs[f"convdiff_{smoother}"] = (
            lambda s=smoother, **kw: tt.convection_diffusion_multigrid_preconditioner(
                N_MG, 2.0, 1.0, smoother=s, max_levels=4, **kw))
    for name, make in pairs.items():
        plain, dm = make(), make(mesh=mesh)
        exchanges.exchanges = 0
        with CommDebugMode() as comm:
            z = dm(shard(cases["r"]))
        out[f"cycle_{name}_exchanges"] = np.asarray(exchanges.exchanges)
        out[f"cycle_{name}_gathers"] = np.asarray(_gathers(comm))
        out[f"cycle_{name}_replicate_from"] = np.asarray(dm.replicate_from)
        out[f"cycle_{name}_z"] = z.to_local().numpy()
        out[f"cycle_{name}_plain"] = plain(r).numpy()[None]  # whole, on every rank

    # Householder GMRES(10) and CG with the halo operator and the mesh=
    # Poisson cycle (gmres_tpu's test_mg_full_depth_sharded_parity), each
    # solve's collectives counted.
    poisson = tt.halo_poisson_operator(mesh)
    mg = tt.poisson_multigrid_preconditioner(N_MG, levels=4, mesh=mesh)
    b = shard(cases["b_mg"])
    for name, solve in (
            ("cg_mg", lambda: tt.cg(poisson, b, tol=1e-9, max_iterations=100, M=mg)),
            ("hh_mg", lambda: tt.gmres(poisson, b, restart=10, tol=1e-10, M=mg,
                                       variant="householder", compute_v_err=False))):
        exchanges.exchanges = 0
        with CommDebugMode() as comm:
            res = solve()
        out[f"{name}_counts"] = _counts(res)
        out[f"{name}_x"] = res.x.to_local().numpy()
        out[f"{name}_comm"] = np.array([_gathers(comm), _count(comm, "all_reduce"),
                                        sum(comm.get_comm_counts().values())])
        out[f"{name}_exchanges"] = np.asarray(exchanges.exchanges)
        out[f"{name}_host_syncs"] = np.asarray(res.host_syncs)


def _count(comm, what: str) -> int:
    return sum(v for k, v in comm.get_comm_counts().items() if what in str(k))


def _gathers(comm) -> int:
    """All-gathers a CommDebugMode saw (c10d's ``_allgather_base_`` is
    all_gather_into_tensor)."""
    return _count(comm, "allgather") + _count(comm, "all_gather")


def _cli(out_dir: str, cases: dict) -> None:
    """``weak-scaling --precond mg`` over every rank of the group."""
    from gmres_tpu_torch.benchmarks.cli import main

    main(cases["weak_scaling_argv"] + ["--device", "cpu", "--jsonl",
                                       os.path.join(out_dir, "weak-scaling-mg.jsonl")])
