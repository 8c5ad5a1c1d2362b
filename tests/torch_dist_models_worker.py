"""One rank of the port's models, cycles and preconditioners on a sharded b,
for tests/test_torch_dist_models.py.

``run(rank, world, init_file, out_dir, cases)`` joins a gloo process group
of ``world`` CPU processes through ``init_multihost`` (rendezvous on
``init_file``) and drives, on DTensors over the mesh of every rank:

* every plain model operator on a row-sharded grid (the DTensor route of
  ``parallel/halo.py``), its all-gathers counted by ``CommDebugMode`` and
  its halo exchanges by ``halo_exchange.exchanges``; ``torch.func.vjp``
  and ``jvp`` of the Poisson and convection–diffusion operators;
* one application of the CSL (complex and split) and 3-D ``mesh=`` cycles,
  beside their ``mesh=None`` cycles on the whole grid;
* gmres_tpu's sharded tests for the models, preconditioners and the AD
  solvers, with their arguments (CommDebugMode around the solves whose
  collectives the tests count, and around one application of the
  anisotropic and varcoef cycles, which gather at their restrictions).

Each rank writes ``out_dir/rank{rank}.npz``: keys ending ``_rows`` hold its
block along axis 0, ``_blk`` along axis 1, and every other key a value equal
on every rank (counts, scalars, the whole-grid results). This module imports
no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

N = 64        # the 2-D operators, cycles and most solves (gmres_tpu's sizes)
N_ANISO = 48  # tests/test_anisotropic.py:92
N_3D = 32     # tests/test_poisson3d.py:89 (and the 3-D cycle)
N_IMPL = 32   # tests/test_implicit.py:157
KH2 = 0.25    # tests/test_complex.py:108, tests/test_helmholtz_split.py:81
CSL_BELOW = 32  # replicate_below of the CSL cycles: the coarsest level replicated
SPLIT_RESTARTS = 3


def run(rank: int, world: int, init_file: str, out_dir: str, cases: dict) -> None:
    import gmres_tpu_torch as tt

    torch.set_num_threads(1)
    mesh = tt.init_multihost(f"file://{init_file}", world, rank, device_type="cpu")
    try:
        out = {}
        _operators(mesh, cases, out)
        _cycles(mesh, cases, out)
        _solves(mesh, cases, out)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _count(comm, what: str) -> int:
    return sum(v for k, v in comm.get_comm_counts().items() if what in str(k))


def _comm(comm) -> np.ndarray:
    """(all-gathers, all-reduces, every collective) a CommDebugMode saw."""
    return np.array([_count(comm, "allgather") + _count(comm, "all_gather"),
                     _count(comm, "all_reduce") + _count(comm, "allreduce"),
                     sum(comm.get_comm_counts().values())])


def _place(a, mesh, dim=0):
    from torch.distributed.tensor import Shard, distribute_tensor

    return distribute_tensor(torch.as_tensor(a), mesh, [Shard(dim)])


def _counted(out, key, fn, comm=True):
    """fn() with its halo exchanges, and where ``comm`` its collectives,
    counted into out."""
    import contextlib

    from torch.distributed.tensor.debug import CommDebugMode

    from gmres_tpu_torch.parallel.halo import halo_exchange

    halo_exchange.exchanges = 0
    with CommDebugMode() if comm else contextlib.nullcontext() as mode:
        res = fn()
    if comm:
        out[f"{key}_comm"] = _comm(mode)
    out[f"{key}_exchanges"] = np.asarray(halo_exchange.exchanges)
    return res


def _operators(mesh, cases: dict, out: dict) -> None:
    """Every plain model operator once on a sharded input."""
    import gmres_tpu_torch as tt
    from gmres_tpu_torch.parallel.halo import blockwise_jvp

    x, x3 = cases["x"], cases["x3"]
    xc = cases["x"] + 1j * cases["v"]
    ops = {
        "poisson": (tt.poisson_operator(N), x, 0),
        "convdiff": (tt.convection_diffusion_operator(N, 0.4, 0.2), x, 0),
        "anisotropic": (tt.anisotropic_operator(N, 0.05), x, 0),
        "helmholtz": (tt.helmholtz_operator(N, KH2), x, 0),
        "helmholtz_complex": (tt.helmholtz_operator(N, KH2), xc, 0),
        "helmholtz_damped": (tt.helmholtz_operator(N, KH2, damping=0.3), xc, 0),
        "helmholtz_split": (tt.helmholtz_split_operator(N, KH2, damping=0.3),
                            np.stack([x, cases["v"]]), 1),
        "poisson3d": (tt.poisson3d_operator(N_3D), x3, 0),
        "varcoef": (tt.varcoef_operator(torch.as_tensor(cases["c"])), x, 0),
        "bratu": (tt.bratu_residual(N, 5.0), 0.1 * x, 0),
    }
    for name, (op, a, dim) in ops.items():
        xa = _place(a, mesh, dim)
        y = _counted(out, f"op_{name}", lambda: op(xa))
        out[f"op_{name}_{'blk' if dim else 'rows'}"] = y.to_local().numpy()
    # varcoef_apply with one field, another, then the first again, on one x.
    xs = _place(x, mesh)
    for key, field in (("c1", "c"), ("c2", "c2"), ("c1_again", "c")):
        c = torch.as_tensor(cases[field])
        out[f"varcoef_apply_{key}_rows"] = _counted(
            out, f"varcoef_apply_{key}", lambda: tt.varcoef_apply(c, xs),
            comm=False).to_local().numpy()
    # Aᵀ·v (vjp on the sharded x) and J·v (jvp on each rank's block) of the
    # plain Poisson and convection–diffusion operators.
    xs, vs = _place(cases["x"], mesh), _place(cases["v"], mesh)
    for name in ("poisson", "convdiff"):
        op = ops[name][0]
        out[f"vjp_{name}_rows"] = _counted(
            out, f"vjp_{name}", lambda: torch.func.vjp(op, xs)[1](vs)[0]).to_local().numpy()
        out[f"jvp_{name}_rows"] = _counted(
            out, f"jvp_{name}", lambda: blockwise_jvp(op, xs, vs)).to_local().numpy()


def _cycles(mesh, cases: dict, out: dict) -> None:
    """One application of each new mesh= cycle beside its mesh=None cycle."""
    import gmres_tpu_torch as tt

    r = cases["r"]
    rc = r + 1j * cases["v"]
    r3 = cases["r3"]
    pairs = {
        "csl_complex": (lambda **kw: tt.csl_multigrid_preconditioner(
            N, KH2, replicate_below=CSL_BELOW if kw else None, **kw), rc, 0),
        "csl_split": (lambda **kw: tt.csl_multigrid_preconditioner(
            N, KH2, layout="split", replicate_below=CSL_BELOW if kw else None, **kw),
            np.stack([rc.real, rc.imag]), 1),
        "poisson3d": (lambda **kw: tt.poisson3d_multigrid_preconditioner(N_3D, **kw), r3, 0),
    }
    for name, (make, a, dim) in pairs.items():
        plain, dm = make(), make(mesh=mesh)
        ra = _place(a, mesh, dim)
        z = _counted(out, f"cycle_{name}", lambda: dm(ra))
        out[f"cycle_{name}_{'blk' if dim else 'rows'}"] = z.to_local().numpy()
        out[f"cycle_{name}_plain"] = plain(torch.as_tensor(a)).numpy()
        out[f"cycle_{name}_levels"] = np.array([dm.replicate_from, dm.levels])


def _counts(res) -> np.ndarray:
    return np.array([res.iterations, getattr(res, "restarts", 0), res.status])


def _solves(mesh, cases: dict, out: dict) -> None:
    """gmres_tpu's sharded tests for this slice, with their arguments."""
    import gmres_tpu_torch as tt
    from gmres_tpu_torch.precond import nystrom as tnys

    def shard(a, dim=0):
        return _place(a, mesh, dim)

    def keep(key, fn, dim=0, comm=False):
        res = _counted(out, key, fn, comm)
        out[f"{key}_counts"] = _counts(res)
        out[f"{key}_x_{'blk' if dim else 'rows'}"] = res.x.to_local().numpy()
        return res

    # tests/test_anisotropic.py:92 (the mesh=None line cycle on a sharded b).
    op = tt.anisotropic_operator(N_ANISO, 0.05)
    m = tt.anisotropic_multigrid_preconditioner(N_ANISO, 0.05)
    b = shard(cases["b_aniso"])
    keep("anisotropic", lambda: tt.cg(op, b, tol=1e-8, M=m))
    _counted(out, "anisotropic_cycle", lambda: m(b))
    # tests/test_varcoef.py:104.
    c = torch.as_tensor(cases["c"])
    op, m = tt.varcoef_operator(c), tt.varcoef_multigrid_preconditioner(c)
    b = shard(cases["b_varcoef"])
    keep("varcoef", lambda: tt.cg(op, b, tol=1e-10, M=m))
    _counted(out, "varcoef_cycle", lambda: m(b))
    # tests/test_poisson3d.py:89 (the mesh= cycle).
    m3 = tt.poisson3d_multigrid_preconditioner(N_3D, mesh=mesh)
    b = shard(cases["b3"])
    keep("poisson3d", lambda: tt.cg(tt.poisson3d_operator(N_3D), b, tol=1e-9,
                                    max_iterations=300, M=m3))
    # tests/test_complex.py:108 and tests/test_helmholtz_split.py:81, each
    # with its CSL cycle's mesh= form.
    mc = tt.csl_multigrid_preconditioner(N, KH2, mesh=mesh, replicate_below=CSL_BELOW)
    b = shard(cases["b_complex"])
    keep("complex", lambda: tt.gmres(
        tt.helmholtz_operator(N, KH2), b, restart=60, tol=1e-8, variant="mgsr", M=mc,
        max_restarts=30, compute_v_err=False, certify="true"))
    ms = tt.csl_multigrid_preconditioner(N, KH2, layout="split", mesh=mesh,
                                         replicate_below=CSL_BELOW)
    b = shard(cases["b_split"], 1)
    keep("split", lambda: tt.gmres(
        tt.helmholtz_split_operator(N, KH2), b, restart=60, tol=1e-9, M=ms,
        variant="mgsr", compute_v_err=False, max_restarts=SPLIT_RESTARTS), dim=1)
    for key, scale in (("split_replicated", 1.0), ("split_perturbed", 1.0 + 1e-15)):
        rep = tt.gmres(tt.helmholtz_split_operator(N, KH2),
                       scale * torch.as_tensor(cases["b_split"]), restart=60, tol=1e-9,
                       variant="mgsr", compute_v_err=False, max_restarts=SPLIT_RESTARTS,
                       M=tt.csl_multigrid_preconditioner(N, KH2, layout="split"))
        out[f"{key}_counts"] = _counts(rep)
        out[f"{key}_x"] = rep.x.numpy()
    # tests/test_deflation.py:141.
    poisson = tt.poisson_operator(N)
    modes = tt.dirichlet_poisson_modes(N, 6, device="cpu")
    p_defl = tt.coarse_space_preconditioner(poisson, modes)
    b = shard(cases["b_poisson"])
    keep("deflation", comm=True, fn=lambda: tt.cg(poisson, b, tol=1e-10, M=p_defl))
    # tests/test_nystrom.py:91, gmres_tpu's sketch patched in; the
    # preconditioner built on the plain x_like (as there) and on a sharded
    # one (the sketch's rows sharded).
    original = tnys._sketch
    tnys._sketch = lambda rank, shape, dtype, device, key: torch.as_tensor(
        cases["sketch"]).to(device, dtype)
    try:
        m_ny, lam = tt.nystrom_preconditioner(poisson, torch.zeros((N, N), dtype=torch.float64),
                                              rank=12)
        x_like = shard(np.zeros((N, N)))
        m_sh, lam_sh = _counted(out, "nystrom_build", lambda: tt.nystrom_preconditioner(
            poisson, x_like, rank=12))
    finally:
        tnys._sketch = original
    out["nystrom_lam"] = lam.numpy()
    out["nystrom_lam_sharded"] = lam_sh.numpy()
    keep("nystrom", lambda: tt.cg(poisson, b, tol=1e-9, M=m_ny))
    keep("nystrom_sharded", lambda: tt.cg(poisson, b, tol=1e-9, M=m_sh))
    # tests/test_spai.py:140.
    m_spai = tt.spai_preconditioner(torch.as_tensor(cases["spai_a"]))
    v = cases["spai_v"]
    vs = shard(v)
    out["spai_rows"] = _counted(out, "spai", lambda: m_spai(vs)).to_local().numpy()
    out["spai_plain"] = m_spai(torch.as_tensor(v)).numpy()
    # tests/test_newton_krylov.py:123.
    u0 = shard(np.zeros((N, N)))
    res = keep("newton", lambda: tt.newton_krylov(tt.bratu_residual(N, 5.0), u0, tol=1e-10))
    out["newton_jv"] = np.asarray(res.jv_products)
    # tests/test_implicit.py:157: ∂L/∂θ and ∂L/∂b through the adjoint solve.
    base = tt.poisson_operator(N_IMPL)

    def a_fn(theta):
        return lambda w: base(w) + theta * w

    def solver(op_, rhs):
        return tt.cg(op_, rhs, tol=1e-12, max_iterations=2000)

    theta = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    b_impl = shard(cases["b_impl"]).requires_grad_()
    x = tt.implicit_solve(a_fn, theta, b_impl, solver=solver, symmetric=True)
    loss = 0.5 * torch.sum(x * x)
    g_theta, g_b = torch.autograd.grad(loss, (theta, b_impl))
    out["implicit_theta"] = np.asarray(float(g_theta))
    out["implicit_b_rows"] = g_b.to_local().numpy()
    # tests/test_polynomial.py:68: d applications of A, no reduction.
    cd = tt.convection_diffusion_operator(N, 0.4, 0.2)
    b_cd = torch.as_tensor(cases["b_cd"])
    poly = tt.gmres_polynomial_preconditioner(cd, b_cd, degree=12)
    bs = shard(b_cd)
    out["poly_rows"] = _counted(out, "poly", lambda: poly(bs)).to_local().numpy()
    out["poly_plain"] = poly(b_cd).numpy()
    # tests/test_chebyshev_solve.py:72: one all-reduce a cycle.
    lo, hi = tt.poisson_spectral_bounds(N)
    b = shard(cases["b_poisson"])
    keep("chebyshev", comm=True, fn=lambda: tt.chebyshev_solve(
        poisson, b, lo, hi, order=16, tol=1e-8, max_cycles=200))
    out["chebyshev_plain"] = _counts(tt.chebyshev_solve(
        poisson, torch.as_tensor(cases["b_poisson"]), lo, hi, order=16, tol=1e-8,
        max_cycles=200))
