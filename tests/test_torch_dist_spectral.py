"""The port's eigensolvers, matrix functions, time steppers and ``mesh=None``
cycles on a row-sharded b, against gmres_tpu and the port's plain runs, at
d = 2 and 4.

Each world size is one spawn of d gloo processes on the CPU
(tests/torch_dist_spectral_worker.py), rendezvous on a file under the
test's temporary directory, every case in the same processes (the two
spawns run at once). Meanwhile the parent runs gmres_tpu's side of its
sharded tests, with their arguments, on the same numpy-seeded inputs. Each
mirrored test holds the port's sharded result as gmres_tpu's own test holds
its sharded one (cited per test); none may raise DTensor's "got mixed
torch.Tensor and DTensor". The ``mesh=None`` cycles handed a DTensor run the
distributed cycle on its mesh: one application is the plain cycle within
1e-13 relative, with one all-gather (at the first replicated level) and no
other collective.
"""

import gc
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import gmres_tpu as gt
from tests import torch_dist_spectral_worker as worker
from tests.torch_parity import assembled, one_rank_mesh, rel_err

WORLDS = (2, 4)


def _cases():
    n = worker.N_FUNM
    k = np.arange(1, n + 1)
    # tests/test_evolve.py's _eigenmode(n, 2, 3).
    u0 = np.outer(np.sin(2 * np.pi * k / (n + 1)), np.sin(3 * np.pi * k / (n + 1)))
    return {
        "lobpcg_x0": np.random.default_rng(1).standard_normal(
            (4, worker.N_LOBPCG, worker.N_LOBPCG)),
        "arnoldi_probe": np.random.default_rng(1).standard_normal(
            (worker.N_ARNOLDI, worker.N_ARNOLDI)),
        "ks_real_probe": np.random.default_rng(1).standard_normal(
            (worker.N_KS_REAL, worker.N_KS_REAL)),
        "funm_b": np.random.default_rng(11).standard_normal((n, n)),
        "evolve_u0": u0,
        "evolve_forcing": np.random.default_rng(12).standard_normal((n, n)),
        "cycle_r": np.random.default_rng(13).standard_normal((worker.N_CYCLE,) * 2),
        "nystrom_sketch": np.asarray(jax.random.normal(
            jax.random.PRNGKey(0), (worker.N_NYSTROM_RANK, n, n), jnp.float64)),
    }


def _jax(cases):
    """gmres_tpu's unsharded runs that its sharded tests compare with."""
    n = worker.N_LOBPCG
    out = {"lobpcg": gt.lobpcg(gt.poisson_operator(n), jnp.asarray(cases["lobpcg_x0"]),
                               tol=1e-8, max_iterations=100,
                               M=gt.poisson_multigrid_preconditioner(n))}
    out["arnoldi"] = gt.arnoldi_eigs(
        gt.convection_diffusion_operator(worker.N_ARNOLDI, 0.4, 0.2),
        jnp.asarray(cases["arnoldi_probe"]), nev=3, steps=20, which="LR", tol=1e-9,
        max_restarts=200)
    out["ks_real"] = gt.arnoldi_eigs_real(
        gt.convection_diffusion_operator(worker.N_KS_REAL, 2.0, 0.5),
        jnp.asarray(cases["ks_real_probe"]), nev=3, steps=20, tol=1e-9, max_restarts=200)
    L = gt.poisson_operator(worker.N_FUNM)
    out["expm"] = np.asarray(gt.expm_multiply(L, jnp.asarray(cases["funm_b"]), 0.4,
                                              steps=30).y)
    out["theta"] = gt.theta_evolve(L, jnp.asarray(cases["evolve_u0"]), dt=0.5, n_steps=6,
                                   solver="cg", tol=1e-12)
    # gmres_tpu's Nyström build on its halo operator, on a sharded x_like
    # of the 8-device mesh (jax.vmap of the operator over the sketch).
    from gmres_tpu.parallel.halo import halo_poisson_operator
    from gmres_tpu.parallel.mesh import shard_grid_vector, solver_mesh

    mesh, n = solver_mesh(8), worker.N_FUNM
    _, lam = gt.nystrom_preconditioner(
        halo_poisson_operator(mesh), shard_grid_vector(jnp.zeros((n, n)), mesh),
        rank=worker.N_NYSTROM_RANK)
    out["nystrom_halo_lam"] = np.asarray(lam)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: port outputs} for both world sizes, and gmres_tpu's side."""
    cases = _cases()
    runs = {}
    try:
        for world in WORLDS:
            out_dir = tmp_path_factory.mktemp(f"dist_spectral_world{world}")
            runs[world] = (out_dir, mp.spawn(
                worker.run, args=(world, os.path.join(out_dir, "rendezvous"),
                                  str(out_dir), cases), nprocs=world, join=False))
        ref = _jax(cases)
    finally:
        for _, ctx in runs.values():
            while not ctx.join():
                pass
    return {world: assembled(out_dir, world) for world, (out_dir, _) in runs.items()}, ref


@pytest.fixture(params=WORLDS, ids=lambda w: f"world{w}")
def dist_run(request, worlds):
    """(port, jax) at one world size."""
    ports, ref = worlds
    return ports[request.param], ref


def _counts(port, key):
    return tuple(int(v) for v in port[f"{key}_counts"])


def _pair_keys(vals):
    """tests/test_krylov_schur_real.py's keys: sorted real parts, sorted
    |imaginary parts|."""
    return np.sort(vals.real), np.sort(np.abs(vals.imag))


def _keyed(v):
    """tests/test_subspace_eigs.py's key: conjugate pairs as multisets."""
    return np.sort_complex(v.real + 1j * np.abs(v.imag))


def test_lobpcg_block_sharded_with_the_plain_cycle(dist_run):
    """tests/test_lobpcg.py:104: the (4, 64, 64) block on [Shard(1)] with the
    plain (mesh=None) Poisson cycle as M converges within 2 iterations of
    gmres_tpu's unsharded run, eigenvalues within rtol 1e-9."""
    port, ref = dist_run
    it, status = _counts(port, "lobpcg")
    assert status == 0 and bool(ref["lobpcg"].converged)
    assert abs(it - int(ref["lobpcg"].iterations)) <= 2
    np.testing.assert_allclose(port["lobpcg_eigenvalues"],
                               np.asarray(ref["lobpcg"].eigenvalues), rtol=1e-9)
    assert str(port["lobpcg_x_type"]) == "DTensor"


def test_arnoldi_eigs_on_a_sharded_probe(dist_run):
    """tests/test_arnoldi_eigs.py:141: Krylov–Schur on a complex basis from a
    [Shard(0)] probe converges within 5 restarts of gmres_tpu's run, the
    eigenvalues within 1e-6 (its complex Gram all-reduced)."""
    port, ref = dist_run
    it, status = _counts(port, "arnoldi")
    assert status == 0 and bool(ref["arnoldi"].converged)
    assert abs(it - int(ref["arnoldi"].iterations)) <= 5
    np.testing.assert_allclose(port["arnoldi_eigenvalues"],
                               np.asarray(ref["arnoldi"].eigenvalues), atol=1e-6)


def test_arnoldi_eigs_real_on_a_sharded_probe(dist_run):
    """tests/test_krylov_schur_real.py:133 with the probe on [Shard(0)]
    (gmres_tpu's runs under ``with mesh:`` on an unsharded probe, a weaker
    test): both converge, the pair keys within 1e-9 of gmres_tpu's."""
    port, ref = dist_run
    _, status = _counts(port, "ks_real")
    assert status == 0 and bool(ref["ks_real"].converged)
    for got, want in zip(_pair_keys(port["ks_real_eigenvalues"]),
                         _pair_keys(np.asarray(ref["ks_real"].eigenvalues))):
        np.testing.assert_allclose(got, want, atol=1e-9)


def test_subspace_eigs_on_a_sharded_probe(dist_run):
    """tests/test_subspace_eigs.py:81 on a [Shard(0)] probe, against the
    port's run on the plain probe (gmres_tpu's compares a ``with mesh:`` run
    of the same program). The sharded block is orthonormalised by CholQR2,
    the plain one by LAPACK's QR.

    At the convection–diffusion default γ (0.4, 0.2) (100 iterations) the
    eigenvalues agree within gmres_tpu's rtol 1e-10. At gmres_tpu's γ
    (1.5, 0.4) the 300
    iterations do not converge (residuals ~6e-3) and the iteration is
    chaotic: the plain run on the probe times (1 + 1e-15) moves the
    eigenvalues by ~1e-7, so no two programs that round differently agree to
    1e-10 there; the sharded run is held within ten times that move."""
    port, _ = dist_run
    calm = _keyed(port["subspace_calm_plain_eigenvalues"])
    np.testing.assert_allclose(_keyed(port["subspace_calm_eigenvalues"]), calm, rtol=1e-10)
    plain = _keyed(port["subspace_chaotic_plain_eigenvalues"])
    move = np.max(np.abs(_keyed(port["subspace_chaotic_perturbed_eigenvalues"]) - plain))
    assert 1e-12 < move < 1e-5
    assert np.max(np.abs(_keyed(port["subspace_chaotic_eigenvalues"]) - plain)) <= 10 * move
    for key in ("calm", "chaotic"):
        assert _counts(port, f"subspace_{key}") == _counts(port, f"subspace_{key}_plain")
        assert str(port[f"subspace_{key}_x_type"]) == "DTensor"


def test_subspace_cholqr2_block_stays_orthonormal(dist_run):
    """The sharded runs' blocks, each step (and the start) at both γ: CholQR2 (two Gram all-reduces a step, no gather) keeps ‖QᵀQ − I‖ at
    rounding."""
    port, _ = dist_run
    steps, worst = port["subspace_orthogonality"]
    assert int(steps) == 301 + 101
    assert worst < 1e-13


def test_expm_multiply_on_a_sharded_b(dist_run):
    """tests/test_funm.py:110: exp(−0.4 A)·b from a [Shard(0)] b within 1e-11
    of gmres_tpu's unsharded result."""
    port, ref = dist_run
    np.testing.assert_allclose(port["expm"], ref["expm"], atol=1e-11)


def test_theta_evolve_with_cg_on_a_sharded_u0(dist_run):
    """tests/test_evolve.py:142: six θ steps with CG from a [Shard(0)] u0:
    gmres_tpu's per-step iterations exactly, u within 1e-12."""
    port, ref = dist_run
    assert int(port["theta_status"]) == 0 and bool(ref["theta"].converged)
    np.testing.assert_array_equal(port["theta_iterations"],
                                  np.asarray(ref["theta"].iterations))
    np.testing.assert_allclose(port["theta"], np.asarray(ref["theta"].u), atol=1e-12)


def test_exponential_evolve_on_a_sharded_u0(dist_run):
    """exponential_evolve with a forcing, u0 and f on [Shard(0)]: its plain
    run's state within 1e-12; both runs' per-step error estimates at
    rounding level (under 1e-13)."""
    port, _ = dist_run
    np.testing.assert_allclose(port["exp_evolve"], port["exp_evolve_plain"], atol=1e-12)
    for key in ("exp_evolve_estimates", "exp_evolve_plain_estimates"):
        assert port[key].shape == (3,) and np.all(port[key] < 1e-13)


def test_trace_funm_probes_placed_like_x_like(dist_run):
    """trace_funm on a [Shard(0)] x_like: the plain run's value within 1e-12
    relative; every probe a DTensor whose rank block is the rank's rows
    only. The probes run batched, as on a plain x_like: one exchange an
    Arnoldi step for the 4 probes (the halo route's block form), the
    Hessenbergs in one host read, and each probe's samples bitwise those of
    the same probes factorized one after another (the plain Poisson
    operator and the halo operator alike)."""
    port, _ = dist_run
    value, plain = float(port["slq_value"]), float(port["slq_plain_value"])
    assert abs(value - plain) <= 1e-12 * abs(plain)
    probes = port["slq_probes"]
    n = worker.N_FUNM
    assert probes.shape[0] == 4 and np.all(probes[:, 0] == 1)
    world = n // int(probes[0, 1])
    assert world in WORLDS and np.all(probes[:, 1:] == (n // world, n))
    assert int(port["slq_exchanges"]) == int(port["slq_halo_exchanges"]) == 20
    assert int(port["slq_host_syncs"]) == 1
    for key in ("slq", "slq_halo"):
        np.testing.assert_array_equal(port[f"{key}_samples"],
                                      port[f"{key}_one_by_one_samples"])
    np.testing.assert_allclose(port["slq_samples"], port["slq_plain_samples"],
                               rtol=1e-12)


def test_nystrom_build_on_the_halo_operator_matches_jax(dist_run):
    """The Nyström preconditioner built on the halo operator and a sharded
    x_like (its sketch's rows a block application each pass: one exchange
    an application to the r rows), gmres_tpu's sketch patched in: λ̂ equal
    to gmres_tpu's build on its halo operator to 1e-10 relative
    (tests/test_torch_dist_models.py's Nyström bound), with two exchanges in
    all (the power pass and the r matvecs)."""
    port, ref = dist_run
    np.testing.assert_allclose(port["nystrom_halo_lam"], ref["nystrom_halo_lam"], rtol=1e-10)
    assert int(port["nystrom_halo_exchanges"]) == 2


CYCLES = ["poisson", "convdiff", "convdiff_mixed_auto", "helmholtz_spd"]


@pytest.mark.parametrize("name", CYCLES)
def test_mesh_none_cycle_on_a_dtensor(dist_run, name):
    """One application of a mesh=None cycle to a row-sharded r is the
    distributed cycle on r's mesh (replicating below 8 rows a rank, the
    mesh= default): the plain cycle within 1e-13 relative (the float32 cycle
    within its own rounding, 1e-6), a [Shard(0)] result, one all-gather
    where a level is replicated (at 4 ranks; at 2 every 64² level stays
    sharded) and none above it, no other collective; a second application
    reuses the cycle built for the mesh, to the bit."""
    port, _ = dist_run
    z = port[f"cycle_{name}"]
    bound = 1e-6 if name.endswith("mixed_auto") else 1e-13
    assert rel_err(z, port[f"cycle_{name}_plain"]) <= bound
    assert np.array_equal(port[f"cycle_{name}_again"], z)
    assert str(port[f"cycle_{name}_placements"]) == "(Shard(dim=0),)"
    gathers = int(port[f"cycle_{name}_gathers"])
    assert gathers == int(port["world"] == 4)
    assert tuple(port[f"cycle_{name}_comm"]) == (gathers, 0, gathers)
    assert int(port[f"cycle_{name}_exchanges"]) > 0


def test_destroyed_groups_mesh_is_collected(tmp_path):
    """A plain operator on a DTensor keeps its halo form on the mesh, not in
    a module dict: once the group is destroyed and the mesh, its DTensors
    and the operator are dropped, the mesh is collected."""
    import gmres_tpu_torch as tt

    with one_rank_mesh(str(tmp_path)) as mesh:
        ref = weakref.ref(mesh)
        op = tt.poisson_operator(16)
        x = tt.shard_grid_vector(torch.ones((16, 16), dtype=torch.float64), mesh)
        y = op(x)
        # (On one rank the local block is the whole grid; full_tensor() would
        # put the mesh in DTensor's own redistribution cache.)
        assert torch.equal(y.to_local(), op(torch.ones((16, 16), dtype=torch.float64)))
        del mesh, x, y, op
    gc.collect()
    assert ref() is None
