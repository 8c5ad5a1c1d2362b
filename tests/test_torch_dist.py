"""The port's distributed solve against gmres_tpu's on the same d-device
mesh, at d = 2 and 4.

Each world size is one spawn of d gloo processes on the CPU
(tests/torch_dist_worker.py), rendezvous on a file under the test's
temporary directory, every case in the same processes; the two spawns
start together. Meanwhile the parent runs gmres_tpu on the first d of conftest.py's 8 virtual CPU
devices, with the same numpy-seeded inputs row-sharded over them: the
Poisson and convection–diffusion operators under GSPMD as gmres_tpu's own
sharded tests run them, the halo operators (shard_map) for Householder
with cbpr2 and for QMR, LSQR and LSMR, whose transposes go through the
port's halo rules, and the ``mesh=`` cycles for the solves they
precondition. The port's row blocks are assembled here.

Each case is held as gmres_tpu's own sharded test holds it (cited per
test): counts equal, or within the band that test allows, and x to its
tolerance. One application of each ``mesh=`` cycle is the port's
``mesh=None`` cycle within 1e-13 relative (gmres_tpu's
tests/test_multigrid.py:123 bound). CommDebugMode counts each solve's
collectives: one all-gather a cycle, at the agglomeration level, besides
the solvers' all-reduces, and nothing else; ``halo_exchange.exchanges``
counts the halo exchanges.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp
from jax.sharding import NamedSharding, PartitionSpec as P

import gmres_tpu as gt
from benchmarks.cli import main as jax_main
from gmres_tpu.models.convection_diffusion import convection_diffusion_coefs
from gmres_tpu.models.helmholtz import helmholtz_coefs, helmholtz_lambda_min
from gmres_tpu.solvers.block_gmres import _orthonormalize_block as jax_orthonormalize
from gmres_tpu.parallel.halo import (
    halo_chebyshev_preconditioner,
    halo_poisson_operator,
    halo_stencil_operator,
)
from gmres_tpu.parallel.mesh import shard_grid_vector, solver_mesh
from tests import torch_dist_worker as worker
from tests.torch_parity import gmres_tpu_in_child, np_poisson, rel_err, seeded

N_FAM, N_MG, N_T = worker.N_FAM, worker.N_MG, worker.N_T
WEAK_SCALING = ["weak-scaling", "--nsize-per-device", "32", "--restart", "10",
                "--tol", "1e-8", "--max-restarts", "200"]


def _stack_poisson(x):
    return np.stack([np_poisson(xi) for xi in x])


def _cases(world):
    cd = convection_diffusion_coefs(0.4, 0.2)
    ones = np.ones
    raw = jax.random.normal(jax.random.PRNGKey(7), (4, N_MG, N_MG), jnp.float64)
    shadow, _ = jax_orthonormalize(raw, float(jnp.finfo(jnp.float64).eps))
    kh2 = 6.0 * helmholtz_lambda_min(N_MG, 0.0)
    return {
        "b_t": np_poisson(ones((N_T, N_T))),
        "b_fam": np_poisson(ones((N_FAM, N_FAM))),
        "b_mg": np_poisson(ones((N_MG, N_MG))),
        "B_gmres": _stack_poisson(seeded(6, (3, N_FAM, N_FAM))),
        "B_cg": seeded(7, (4, N_MG, N_MG)),
        "b_cd": np.asarray(gt.convection_diffusion_operator(N_MG, 0.4, 0.2)(
            jnp.ones((N_MG, N_MG)))),
        "b_cd48": np.asarray(gt.convection_diffusion_operator(N_FAM, 0.4, 0.2)(
            jnp.ones((N_FAM, N_FAM)))),
        "b_hz": np.asarray(gt.helmholtz_operator(N_MG, kh2)(jnp.ones((N_MG, N_MG)))),
        "kh2": kh2,
        "cd": cd,
        "idrs_shadow": np.asarray(shadow),
        "probe": seeded(11, (N_T, N_T)),
        "b_cdt": np.asarray(gt.convection_diffusion_operator(N_T, 0.4, 0.2)(
            jnp.ones((N_T, N_T)))),
        "x_t": seeded(13, (N_T, N_T)),
        "v_t": seeded(14, (N_T, N_T)),
        "r": seeded(12, (N_MG, N_MG)),
        "weak_scaling_argv": WEAK_SCALING + ["--max-devices", str(world)],
    }


def _jax(world, cases):
    """gmres_tpu on the first ``world`` CPU devices, every case the worker
    runs."""
    mesh = solver_mesh(world)

    def shard(a):
        return shard_grid_vector(jnp.asarray(a), mesh)

    def block(a):
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(None, "grid", None)))

    def run(fn, *args):
        return jax.jit(fn)(*args)

    poisson = gt.poisson_operator
    op_f, op_mg, op_t = poisson(N_FAM), poisson(N_MG), poisson(N_T)
    cd = gt.convection_diffusion_operator(N_MG, 0.4, 0.2)
    cd48 = gt.convection_diffusion_operator(N_FAM, 0.4, 0.2)
    halo = halo_poisson_operator(mesh)
    out = {}
    out["hh"] = run(lambda v: gt.gmres(
        halo, v, restart=12, tol=1e-10, M=halo_chebyshev_preconditioner(mesh, 0.2, 8.2),
        variant="householder", max_restarts=200), shard(cases["b_t"]))
    cbpr2 = gt.chebyshev_preconditioner(op_f, 0.2, 8.2)
    b_fam = shard(cases["b_fam"])
    out["fgmres"] = run(lambda v: gt.fgmres(op_f, v, restart=15, tol=1e-9, M=cbpr2,
                                            max_restarts=100), b_fam)
    cheb16 = gt.chebyshev_preconditioner(op_f, 0.005, 8.0, order=16)
    out["sstep_gmres"] = run(lambda v: gt.sstep_gmres(op_f, v, s=8, tol=1e-8, M=cheb16),
                             b_fam)
    out["lgmres"] = run(lambda v: gt.lgmres(op_f, v, restart=10, aug=3, tol=1e-8,
                                            max_restarts=500), b_fam)
    out["gmres_dr"] = run(lambda v: gt.gmres_dr(op_f, v, restart=20, deflate=6,
                                                tol=1e-10, max_restarts=100), b_fam)
    out["block_gmres"] = run(lambda v: gt.block_gmres(op_f, v, restart=20, tol=1e-10,
                                                      M=cbpr2, max_restarts=100),
                             block(cases["B_gmres"]))
    b_cd = shard(cases["b_cd"])
    out["idrs"] = run(lambda v: gt.idrs(cd, v, s=4, tol=1e-9, max_iterations=3000), b_cd)
    out["gcrodr"] = run(lambda v: gt.gcrodr(cd, v, k=6, restart=24, tol=1e-10,
                                            max_restarts=100), b_cd)
    out["gcrodr_mixed"] = run(lambda v: gt.gcrodr(cd48, v, k=4, restart=16, tol=1e-9,
                                                  max_restarts=80,
                                                  inner_dtype=jnp.float32),
                              shard(cases["b_cd48"]))
    out["block_cg"] = run(lambda v: gt.block_cg(op_mg, v, tol=1e-9), block(cases["B_cg"]))
    out["sstep_cg"] = run(lambda v: gt.sstep_cg(op_mg, v, s=4, tol=1e-10),
                          shard(cases["b_mg"]))
    b_t = shard(cases["b_t"])
    for name in ("qmr", "lsqr", "lsmr"):
        out[name] = run(lambda v, f=getattr(gt, name): f(halo, v, tol=1e-8,
                                                        max_iterations=2000), b_t)
    halo_cd = halo_stencil_operator(mesh, cases["cd"])
    for name in ("qmr", "lsqr"):
        out[f"{name}_cd"] = run(lambda v, f=getattr(gt, name): f(
            halo_cd, v, tol=1e-8, max_iterations=2000), shard(cases["b_cdt"]))
    x, v = shard(cases["x_t"]), shard(cases["v_t"])
    out["cd_vjp"] = np.asarray(jax.vjp(halo_cd, x)[1](v)[0])
    out["cd_jvp"] = np.asarray(jax.jvp(halo_cd, (x,), (v,))[1])
    out["cd_av"] = np.asarray(halo_cd(v))
    cd_mg = gt.convection_diffusion_multigrid_preconditioner(N_MG, 0.4, 0.2, mesh=mesh)
    for name in ("bicgstab", "cgs", "tfqmr"):
        out[name] = run(lambda v, f=getattr(gt, name): f(cd, v, tol=1e-9,
                                                        max_iterations=200, M=cd_mg), b_cd)
    out["bicgstabl"] = run(lambda v: gt.bicgstabl(cd, v, ell=2, tol=1e-9,
                                                  max_iterations=500), b_cd)
    hz = gt.helmholtz_operator(N_MG, cases["kh2"])
    hz_mg = gt.helmholtz_shifted_laplacian_preconditioner(N_MG, cases["kh2"], mesh=mesh)
    out["minres"] = run(lambda v: gt.minres(hz, v, tol=1e-9, max_iterations=1000,
                                            M=hz_mg), shard(cases["b_hz"]))
    out["lanczos"] = np.array([float(v) for v in jax.jit(
        lambda v: gt.lanczos_bounds(op_t, v, steps=20))(shard(cases["probe"]))])
    mg = gt.poisson_multigrid_preconditioner(N_MG, levels=4, mesh=mesh)
    b_mg = shard(cases["b_mg"])
    out["cg_mg"] = run(lambda v: gt.cg(op_mg, v, tol=1e-9, max_iterations=100, M=mg), b_mg)
    out["hh_mg"] = run(lambda v: gt.gmres(op_mg, v, restart=10, tol=1e-10, M=mg,
                                          compute_v_err=False), b_mg)
    return out


WORLDS = (2, 4)


def _assembled(out_dir, world) -> dict:
    """The worker's ranks' outputs: ``_blk`` keys joined along axis 1, 2-D
    arrays along axis 0, every other key equal on every rank."""
    ranks = [np.load(os.path.join(out_dir, f"rank{r}.npz")) for r in range(world)]
    port = {}
    for key in ranks[0].files:
        vals = [z[key] for z in ranks]
        if key.endswith("_blk"):
            port[key[:-4]] = np.concatenate(vals, axis=1)
        elif vals[0].ndim == 2:
            port[key] = np.concatenate(vals, axis=0)
        else:
            for v in vals[1:]:
                np.testing.assert_array_equal(v, vals[0], err_msg=key)
            port[key] = vals[0]
    return port


def _jax_side(world, cases, out_dir):
    """gmres_tpu's results at one world size, and its weak-scaling program's
    rows in out_dir/jax-ws.jsonl."""
    ref = _jax(world, cases)
    jax_main(cases["weak_scaling_argv"] + ["--jsonl", os.path.join(out_dir, "jax-ws.jsonl")])
    return ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: (port, jax, world, out_dir)} for both world sizes: the
    worker's assembled outputs and gmres_tpu's results. The two spawns run
    at once (their ranks mostly wait on messages) while gmres_tpu's side
    runs for each, the last world's in a process of its own beside the
    parent's."""
    runs, refs = {}, {}
    try:
        for world in WORLDS:
            out_dir = tmp_path_factory.mktemp(f"dist_world{world}")
            cases = _cases(world)
            runs[world] = (out_dir, cases, mp.spawn(
                worker.run, args=(world, os.path.join(out_dir, "rendezvous"),
                                  str(out_dir), cases), nprocs=world, join=False))
        last = WORLDS[-1]
        child = gmres_tpu_in_child(_jax_side, last, runs[last][1], str(runs[last][0]))
        for world in WORLDS[:-1]:
            refs[world] = _jax_side(world, runs[world][1], str(runs[world][0]))
        refs[last] = child()
    finally:
        for _, _, ctx in runs.values():
            while not ctx.join():
                pass
    return {world: (_assembled(out_dir, world), refs[world], world, out_dir)
            for world, (out_dir, _, _) in runs.items()}


@pytest.fixture(params=WORLDS, ids=lambda w: f"world{w}")
def dist_run(request, worlds):
    """(port, jax, world, out_dir) at one world size."""
    return worlds[request.param]


def _counts(port, name):
    it, rst, status = (int(v) for v in port[f"{name}_counts"])
    return it, rst, status


def test_householder_gmres_on_a_sharded_b(dist_run):
    """Householder GMRES(12) with cbpr2 on the halo route (the Hessenberg
    head and the reflector's shifted entry read and written through
    ops/flat.py): gmres_tpu's counts and status, x to 1e-9 relative, the
    residual history to 1e-9 relative above 1e-15, and v_err (the compact-WY
    basis audit, ~1e-30) to 1e-14 absolute."""
    port, ref, _, _ = dist_run
    r = ref["hh"]
    assert _counts(port, "hh") == (int(r.iterations), int(r.restarts), int(r.status))
    assert int(r.status) == 0
    assert rel_err(port["hh_x"], r.x) < 1e-9
    np.testing.assert_allclose(port["hh_history"], np.asarray(r.residual_history),
                               rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(port["hh_v_err"], np.asarray(r.v_err), rtol=0, atol=1e-14)


@pytest.mark.parametrize("name,held", [
    ("fgmres", "iterations restarts"),      # tests/test_fgmres.py:93
    ("sstep_gmres", "restarts"),            # tests/test_sstep.py:67
    ("lgmres", "iterations restarts"),      # tests/test_lgmres.py:95
    ("gmres_dr", "iterations restarts"),    # tests/test_gmres_dr.py:121
])
def test_gmres_family_counts(dist_run, name, held):
    """The GMRES family on a sharded b: the counts gmres_tpu's own sharded
    test holds equal, and status 0."""
    port, ref, _, _ = dist_run
    it, rst, status = _counts(port, name)
    r = ref[name]
    assert status == int(r.status) == 0
    if "iterations" in held:
        assert it == int(r.iterations)
    assert rst == int(r.restarts)
    if name == "gmres_dr":
        np.testing.assert_allclose(port["gmres_dr_x"], np.asarray(r.x), atol=1e-9)


def test_block_solvers(dist_run):
    """Block GMRES (tests/test_block_gmres.py:132: restarts equal, X to
    1e-9) and block CG (tests/test_block_cg.py:92: iterations equal, X to
    1e-9) on a [Shard(1)] block: one all-reduce for each Gram."""
    port, ref, _, _ = dist_run
    r = ref["block_gmres"]
    _, rst, status = _counts(port, "block_gmres")
    assert status == int(r.status) == 0 and rst == int(r.restarts)
    np.testing.assert_allclose(port["block_gmres_x"], np.asarray(r.x), atol=1e-9)
    r = ref["block_cg"]
    it, _, status = _counts(port, "block_cg")
    assert status == int(r.status) == 0 and it == int(r.iterations)
    np.testing.assert_allclose(port["block_cg_x"], np.asarray(r.x), atol=1e-9)


def test_idrs_and_gcrodr(dist_run):
    """IDR(s) with gmres_tpu's shadow block (tests/test_idrs.py:71: within
    2), GCRO-DR (tests/test_gcrodr.py:109: restarts within 1, x to 1e-8)
    and its mixed-precision path (:188: restarts equal, x to 1e-6)."""
    port, ref, _, _ = dist_run
    it, _, status = _counts(port, "idrs")
    assert status == int(ref["idrs"].status) == 0
    assert abs(it - int(ref["idrs"].iterations)) <= 2
    for name, band, atol in (("gcrodr", 1, 1e-8), ("gcrodr_mixed", 0, 1e-6)):
        r = ref[name]
        _, rst, status = _counts(port, name)
        assert status == int(r.status) == 0
        assert abs(rst - int(r.restarts)) <= band
        np.testing.assert_allclose(port[f"{name}_x"], np.asarray(r.x), atol=atol)


def test_sstep_cg(dist_run):
    """s-step CG (tests/test_sstep_cg.py:90: iterations equal, x to 1e-12):
    its (2·(2s+1)+1)² Gram in one all-reduce."""
    port, ref, _, _ = dist_run
    r = ref["sstep_cg"]
    it, _, status = _counts(port, "sstep_cg")
    assert status == int(r.status) == 0 and it == int(r.iterations)
    np.testing.assert_allclose(port["sstep_cg_x"], np.asarray(r.x), atol=1e-12)


@pytest.mark.parametrize("name", ["qmr", "lsqr", "lsmr", "qmr_cd", "lsqr_cd"])
def test_transpose_solvers_on_the_halo_operator(dist_run, name):
    """QMR, LSQR and LSMR derive Aᵀ of the halo operator through its
    transpose rule (the exchange outside the traced graph): they converge
    within 2 of gmres_tpu's count on its halo operator
    (tests/test_lsqr.py:100's band), one transpose rule an iteration. The
    ``_cd`` cases run on the nonsymmetric convection–diffusion operator,
    where a wrong mirror would not be Aᵀ."""
    port, ref, _, _ = dist_run
    it, _, status = _counts(port, name)
    r = ref[name]
    assert status == int(r.status) == 0
    assert abs(it - int(r.iterations)) <= 2
    assert int(port["transposes"]) > 0
    np.testing.assert_allclose(port[f"{name}_x"], 1.0, atol=1e-6)


@pytest.mark.parametrize("name,band", [
    ("bicgstab", 2),     # tests/test_torch_bicgstab.py's port band
    ("cgs", 1),          # tests/test_cgs.py:125
    ("tfqmr", 1),        # tests/test_tfqmr.py:92
    ("bicgstabl", 1),    # tests/test_bicgstabl.py:107
    ("minres", 2),       # tests/test_minres.py:137 (the mesh= SPD cycle)
])
def test_short_recurrences_with_the_mesh_cycles(dist_run, name, band):
    """The solvers that already ran on a sharded b, now with the mesh=
    convection–diffusion and Helmholtz cycles: gmres_tpu's counts within the
    band of its own sharded test, status 0."""
    port, ref, _, _ = dist_run
    it, _, status = _counts(port, name)
    r = ref[name]
    assert status == int(r.status) == 0
    assert abs(it - int(r.iterations)) <= band


def test_halo_rules_on_a_nonsymmetric_stencil(dist_run):
    """Aᵀ·v (torch.func.vjp on the sharded x: the transpose rule, one
    exchange of v and the mirrored stencil) and J·v (torch.func.jvp on each
    rank's block: the tangent rule) of the convection–diffusion halo
    operator equal jax.vjp and jax.jvp of gmres_tpu's halo operator on the
    same inputs within 1e-12 relative."""
    port, ref, _, _ = dist_run
    assert rel_err(port["cd_vjp"], ref["cd_vjp"]) <= 1e-12
    assert rel_err(port["cd_jvp"], ref["cd_jvp"]) <= 1e-12
    assert int(port["tangents"]) == 1
    # The case tells Aᵀ from A: a rule that mirrored nothing would fail.
    assert rel_err(ref["cd_av"], ref["cd_vjp"]) > 1e-2


def test_lanczos_bounds(dist_run):
    port, ref, _, _ = dist_run
    np.testing.assert_allclose(port["lanczos"], ref["lanczos"], rtol=1e-10)


CYCLES = ["poisson", "poisson_allsharded", "poisson_replicated", "helmholtz",
          "convdiff_jacobi", "convdiff_auto", "convdiff_rbgs"]


@pytest.mark.parametrize("name", CYCLES)
def test_mesh_cycle_is_the_plain_cycle(dist_run, name):
    """One application of a mesh= cycle equals the mesh=None cycle within
    1e-13 relative, with one all-gather where a level is replicated and
    none otherwise."""
    port, _, world, _ = dist_run
    assert rel_err(port[f"cycle_{name}_z"], port[f"cycle_{name}_plain"][0]) <= 1e-13
    replicate_from = int(port[f"cycle_{name}_replicate_from"])
    levels = 3 if name.startswith("convdiff") else 4
    assert int(port[f"cycle_{name}_gathers"]) == (1 if replicate_from < levels else 0)
    if name == "poisson":
        # Default replicate_below = 8 rows a rank: 16 on 2 ranks, 32 on 4.
        assert replicate_from == {2: 3, 4: 2}[world]


@pytest.mark.parametrize("name,replicate_from", [
    ("poisson", None), ("poisson_allsharded", 4), ("poisson_replicated", 0)])
def test_mesh_cycle_exchanges(dist_run, name, replicate_from):
    """Halo exchanges of one Poisson cycle (levels 64, 32, 16, 8; order-3
    smoothers, order-32 coarse solve): each sharded level above the coarsest
    2 + 2·(3 − 1), a sharded coarsest level 31, a replicated level none."""
    port, _, _, _ = dist_run
    rf = int(port[f"cycle_{name}_replicate_from"])
    if replicate_from is not None:
        assert rf == replicate_from
    expected = 6 * min(rf, 3) + (31 if rf == 4 else 0)
    assert int(port[f"cycle_{name}_exchanges"]) == expected


@pytest.mark.parametrize("name", ["cg_mg", "hh_mg"])
def test_solves_with_the_mesh_cycle(dist_run, name):
    """CG and Householder GMRES(10) with the halo operator and the mesh=
    Poisson cycle (tests/test_multigrid.py:100's parity: gmres_tpu's counts
    with its own mesh= cycle, x to 1e-8 of 1). CommDebugMode: one
    all-gather a cycle application, the rest all-reduces, nothing else; one
    halo exchange an operator application plus the cycle's."""
    port, ref, _, _ = dist_run
    r = ref[name]
    it, rst, status = _counts(port, name)
    assert status == int(r.status) == 0
    assert it == int(r.iterations)
    if name == "hh_mg":
        assert rst == int(r.restarts)
    np.testing.assert_allclose(port[f"{name}_x"], 1.0, atol=1e-8)
    gathers, reduces, total = (int(v) for v in port[f"{name}_comm"])
    # Cycle applications: CG's initial one and one an iteration; GMRES's one
    # an inner iteration and one a true residual (the restarts + 1).
    cycles = it + 1 if name == "cg_mg" else (rst - 1) * 10 + it + rst + 1
    assert gathers == cycles
    assert total == gathers + reduces and reduces > 0
    per_cycle = int(port["cycle_poisson_exchanges"])
    operator_applications = int(port[f"{name}_exchanges"]) - cycles * per_cycle
    assert operator_applications == (it + 1 if name == "cg_mg" else cycles)


def test_weak_scaling_mg(dist_run):
    """``weak-scaling --precond mg`` at d = 1, 2, 4 (world 4) or 1, 2
    (world 2), nsize-per-device 32: gmres_tpu's program's iterations and
    restarts for the same d, status 0."""
    _, _, world, out_dir = dist_run
    with open(out_dir / "weak-scaling-mg.jsonl") as f:
        port = [json.loads(line) for line in f]
    with open(out_dir / "jax-ws.jsonl") as f:
        ref = {r["name"]: r for r in (json.loads(line) for line in f)}
    assert [r["devices"] for r in port] == [1, 2, 4][:world.bit_length()]
    for p in port:
        j = ref[p["name"]]
        assert (p["iterations"], p["restarts"]) == (j["iterations"], j["restarts"])
        assert p["status"] == 0 and p["nvars"] == j["nvars"]
