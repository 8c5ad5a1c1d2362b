"""One rank of the port's eigensolvers, matrix functions, time steppers and
``mesh=None`` cycles on a sharded b, for tests/test_torch_dist_spectral.py.

``run(rank, world, init_file, out_dir, cases)`` joins a gloo process group
of ``world`` CPU processes through ``init_multihost`` (rendezvous on
``init_file``) and drives, on DTensors over the mesh of every rank, with
gmres_tpu's sharded tests' arguments:

* LOBPCG on a (k, N, N) block placed ``[Shard(1)]`` with the plain
  (``mesh=None``) Poisson cycle as M; Krylov–Schur on a complex and on a real
  Schur basis; subspace iteration (beside its run on plain tensors, and
  beside one on a probe changed by 1e-15 relative: the chaos of the
  iteration at gmres_tpu's arguments), and the orthonormality of its
  CholQR2 block after the power steps;
* expm_multiply, exponential_evolve, theta_evolve with CG and trace_funm
  (its probes' placement tapped), each beside the plain run;
* one application of the Poisson, convection–diffusion and Helmholtz SPD
  ``mesh=None`` cycles on a row-sharded r, beside the plain cycle, its
  collectives counted by ``CommDebugMode``.

Each rank writes ``out_dir/rank{rank}.npz``: keys ending ``_rows`` hold its
block along axis 0, ``_blk`` along axis 1, and every other key a value equal
on every rank. This module imports no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from tests.torch_dist_models_worker import _counted, _place

N_LOBPCG = 64      # tests/test_lobpcg.py:104
N_ARNOLDI = 24     # tests/test_arnoldi_eigs.py:141
N_KS_REAL = 16     # tests/test_krylov_schur_real.py:133
N_SUBSPACE = 32    # tests/test_subspace_eigs.py:81
N_FUNM = 64        # tests/test_funm.py:110, tests/test_evolve.py:142
N_CYCLE = 64
N_NYSTROM_RANK = 12  # tests/test_nystrom.py:91's rank
# Subspace iteration at gmres_tpu's γ, and at one where the dominant Ritz
# values are not chaotic (the convection–diffusion default γ).
SUBSPACE_GAMMAS = {"chaotic": (1.5, 0.4), "calm": (0.4, 0.2)}
SUBSPACE_ITERS = {"chaotic": 300, "calm": 100}  # gmres_tpu's 300; the calm case settles sooner


def run(rank: int, world: int, init_file: str, out_dir: str, cases: dict) -> None:
    import gmres_tpu_torch as tt

    torch.set_num_threads(1)
    mesh = tt.init_multihost(f"file://{init_file}", world, rank, device_type="cpu")
    try:
        out = {}
        _eigensolvers(mesh, cases, out)
        _functions(mesh, cases, out)
        _cycles(mesh, cases, out)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _eig(out, key, res):
    out[f"{key}_eigenvalues"] = np.asarray(res.eigenvalues)
    out[f"{key}_counts"] = np.array([res.iterations, res.status])
    out[f"{key}_x_type"] = np.asarray(type(res.x).__name__)


def _eigensolvers(mesh, cases: dict, out: dict) -> None:
    import gmres_tpu_torch as tt
    from gmres_tpu_torch.ops.blas import gram
    from gmres_tpu_torch.solvers import subspace_eigs as sub

    # tests/test_lobpcg.py:104: the block [Shard(1)], the plain cycle as M.
    n = N_LOBPCG
    x0 = _place(cases["lobpcg_x0"], mesh, 1)
    _eig(out, "lobpcg", tt.lobpcg(tt.poisson_operator(n), x0, tol=1e-8, max_iterations=100,
                                  M=tt.poisson_multigrid_preconditioner(n)))
    # tests/test_arnoldi_eigs.py:141.
    n = N_ARNOLDI
    probe = _place(cases["arnoldi_probe"], mesh)
    _eig(out, "arnoldi", tt.arnoldi_eigs(tt.convection_diffusion_operator(n, 0.4, 0.2), probe,
                                         nev=3, steps=20, which="LR", tol=1e-9,
                                         max_restarts=200))
    # tests/test_krylov_schur_real.py:133, the probe [Shard(0)].
    n = N_KS_REAL
    probe = _place(cases["ks_real_probe"], mesh)
    _eig(out, "ks_real", tt.arnoldi_eigs_real(tt.convection_diffusion_operator(n, 2.0, 0.5),
                                              probe, nev=3, steps=20, tol=1e-9,
                                              max_restarts=200))
    # tests/test_subspace_eigs.py:81, beside its run on plain tensors; the
    # sharded runs' CholQR2 blocks tapped for ‖QᵀQ − I‖ after each step.
    n = N_SUBSPACE
    ones = torch.ones((n, n), dtype=torch.float64)
    original, worst = sub._orthonormal_rows, []

    def tapped(rows):
        q = original(rows)
        if type(q).__name__ == "DTensor":
            eye = torch.eye(q.shape[0], dtype=torch.float64)
            worst.append(float(torch.max(torch.abs(gram(q, q) - eye))))
        return q

    sub._orthonormal_rows = tapped
    try:
        for key, g in SUBSPACE_GAMMAS.items():
            op = tt.convection_diffusion_operator(n, *g)
            runs = (("", _place(ones, mesh)), ("_plain", ones))
            if key == "chaotic":
                runs += (("_perturbed", ones * (1.0 + 1e-15)),)
            for tag, probe in runs:
                _eig(out, f"subspace_{key}{tag}", tt.subspace_eigs(
                    op, probe, nev=3, guard=5, iters=SUBSPACE_ITERS[key]))
    finally:
        sub._orthonormal_rows = original
    out["subspace_orthogonality"] = np.array([len(worst), max(worst)])


def _functions(mesh, cases: dict, out: dict) -> None:
    import gmres_tpu_torch as tt
    from gmres_tpu_torch.solvers import funm
    from gmres_tpu_torch.solvers.lanczos import arnoldi_factorization

    n = N_FUNM
    L = tt.poisson_operator(n)
    b = cases["funm_b"]
    bs = _place(b, mesh)
    # tests/test_funm.py:110.
    out["expm_rows"] = tt.expm_multiply(L, bs, 0.4, steps=30).y.to_local().numpy()
    # tests/test_evolve.py:142.
    u0 = cases["evolve_u0"]
    res = tt.theta_evolve(L, _place(u0, mesh), dt=0.5, n_steps=6, solver="cg", tol=1e-12)
    out["theta_iterations"] = res.iterations.numpy()
    out["theta_status"] = np.asarray(res.status)
    out["theta_rows"] = res.u.to_local().numpy()
    # exponential_evolve against its plain run (forcing sharded alike).
    f = cases["evolve_forcing"]
    kw = dict(dt=0.1, n_steps=3, steps=20)
    res = tt.exponential_evolve(L, _place(u0, mesh), forcing=_place(f, mesh), **kw)
    out["exp_evolve_rows"] = res.u.to_local().numpy()
    out["exp_evolve_estimates"] = res.error_estimates.numpy()
    plain = tt.exponential_evolve(L, torch.as_tensor(u0), forcing=torch.as_tensor(f), **kw)
    out["exp_evolve_plain"] = plain.u.numpy()
    out["exp_evolve_plain_estimates"] = plain.error_estimates.numpy()
    # trace_funm: the probes placed like x_like (each rank's rows tapped),
    # batched as lanes; then the same probes one after another.
    seen = []
    original = funm.arnoldi_factorization_steps

    def tapped(A, z, steps):
        seen.append((type(z).__name__, tuple(z.to_local().shape)
                     if hasattr(z, "to_local") else tuple(z.shape)))
        return original(A, z, steps)

    funm.arnoldi_factorization_steps = tapped
    try:
        res = _counted(out, "slq", lambda: tt.trace_funm(L, torch.log, bs, n_probes=4,
                                                         steps=20))
    finally:
        funm.arnoldi_factorization_steps = original
    out["slq_probes"] = np.array([[t == "DTensor", *shape] for t, shape in seen])
    out["slq_value"] = np.asarray(float(res.value))
    out["slq_samples"] = res.samples.numpy()
    out["slq_host_syncs"] = np.asarray(res.host_syncs)
    z = funm.shard_rows_like(funm._rademacher(4, (n, n), bs.dtype, bs.device, 0), bs)
    hosts = [arnoldi_factorization(L, z[i], 20)[1].to("cpu", torch.float64)
             for i in range(4)]
    one_by_one = funm._trace_result(torch.log, z, hosts, 20, bs, 4)
    out["slq_one_by_one_samples"] = one_by_one.samples.numpy()
    # The halo operator's probes, batched and one by one alike.
    halo = tt.halo_poisson_operator(mesh)
    res = _counted(out, "slq_halo", lambda: tt.trace_funm(halo, torch.log, bs, n_probes=4,
                                                          steps=20))
    out["slq_halo_samples"] = res.samples.numpy()
    hosts = [arnoldi_factorization(halo, z[i], 20)[1].to("cpu", torch.float64)
             for i in range(4)]
    out["slq_halo_one_by_one_samples"] = funm._trace_result(
        torch.log, z, hosts, 20, bs, 4).samples.numpy()
    plain = tt.trace_funm(L, torch.log, torch.as_tensor(b), n_probes=4, steps=20)
    out["slq_plain_value"] = np.asarray(float(plain.value))
    out["slq_plain_samples"] = plain.samples.numpy()
    # The Nyström build on the halo operator (a block application of A to
    # the sketch's sharded rows), gmres_tpu's sketch patched in.
    from gmres_tpu_torch.precond import nystrom as tnys

    original_sketch = tnys._sketch
    tnys._sketch = lambda rank, shape, dtype, device, key: torch.as_tensor(
        cases["nystrom_sketch"]).to(device, dtype)
    try:
        _, lam = _counted(out, "nystrom_halo", lambda: tt.nystrom_preconditioner(
            halo, _place(np.zeros((n, n)), mesh), rank=N_NYSTROM_RANK))
    finally:
        tnys._sketch = original_sketch
    out["nystrom_halo_lam"] = lam.numpy()


def _cycles(mesh, cases: dict, out: dict) -> None:
    """One application of each mesh=None cycle on a row-sharded r."""
    import gmres_tpu_torch as tt
    from gmres_tpu_torch.precond.multigrid import _default_levels, _replicate_from

    n = N_CYCLE
    r = cases["cycle_r"]
    # Every cycle here coarsens 64² to 16²; the first replicated level's
    # gather happens where one lies below 8 rows a rank.
    _, sizes = _default_levels(n, None)
    out["world"] = np.asarray(mesh.size())
    cycles = {
        "poisson": tt.poisson_multigrid_preconditioner(n),
        "convdiff": tt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2),
        "convdiff_mixed_auto": tt.convection_diffusion_multigrid_preconditioner(
            n, 0.4, 0.2, smoother="auto", internal_dtype=torch.float32),
        "helmholtz_spd": tt.helmholtz_shifted_laplacian_preconditioner(n, 0.5),
    }
    for name, m in cycles.items():
        rs = _place(r, mesh)
        z = _counted(out, f"cycle_{name}", lambda: m(rs))
        out[f"cycle_{name}_placements"] = np.asarray(str(tuple(z.placements)))
        out[f"cycle_{name}_gathers"] = np.asarray(
            int(_replicate_from(sizes, mesh, None) < len(sizes)))
        out[f"cycle_{name}_rows"] = z.to_local().numpy()
        out[f"cycle_{name}_plain"] = m(torch.as_tensor(r)).numpy()
        # A second application reuses the cycle built for this mesh.
        out[f"cycle_{name}_again_rows"] = m(rs).to_local().numpy()
