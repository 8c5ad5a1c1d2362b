"""The port's plain model operators, its CSL and 3-D ``mesh=`` cycles and
gmres_tpu's sharded suite for the models, preconditioners and AD solvers,
against gmres_tpu on the same d-device mesh, at d = 2 and 4.

Each world size is one spawn of d gloo processes on the CPU
(tests/torch_dist_models_worker.py), rendezvous on a file under the test's
temporary directory, every case in the same processes. Meanwhile the
parent runs gmres_tpu on the first d of conftest.py's 8 virtual CPU
devices with the same numpy-seeded inputs: its plain operators and
``mesh=`` cycles under GSPMD (which lowers the stencils' shifts to halo
permutes), and its sharded tests' solves with their arguments. The
port's blocks are assembled here.

A plain operator on a row-sharded DTensor takes the DTensor route: one halo
exchange an application and no all-gather (``CommDebugMode``). One
application of a ``mesh=`` cycle is the port's ``mesh=None`` cycle within
1e-13 relative (gmres_tpu's tests/test_multigrid.py:123 bound) and
gmres_tpu's ``mesh=`` cycle within 1e-12, with one all-gather. Each
mirrored test is held as gmres_tpu's own sharded test holds it (cited per
test). The refusals of a DTensor by every kernel wrapper run here too, in
this process on a one-rank gloo mesh.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import NamedSharding, PartitionSpec as P

import gmres_tpu as gt
from gmres_tpu.parallel.mesh import solver_mesh
from gmres_tpu.precond.multigrid import csl_multigrid_preconditioner
from tests import torch_dist_models_worker as worker
from tests.torch_parity import assembled as _assembled, gmres_tpu_in_child, one_rank_mesh, rel_err

N, N_ANISO, N_3D, N_IMPL = worker.N, worker.N_ANISO, worker.N_3D, worker.N_IMPL
KH2, CSL_BELOW = worker.KH2, worker.CSL_BELOW


def _tridiag(rng, n):
    """tests/test_spai.py's nonsymmetric tridiagonal matrix."""
    a = np.zeros((n, n))
    a[np.arange(n), np.arange(n)] = 4.0 + 0.1 * rng.standard_normal(n)
    off = 1.0 + 0.2 * rng.standard_normal(n - 1)
    a[np.arange(n - 1), np.arange(1, n)] = off
    a[np.arange(1, n), np.arange(n - 1)] = -0.8 * off
    return a


def _cases():
    rng = np.random.default_rng(2026)
    g = jnp.linspace(0, 1, N)
    xx, yy = jnp.meshgrid(g, g, indexing="ij")
    c = np.asarray(1.0 + 0.9 * jnp.sin(2 * jnp.pi * xx) * jnp.cos(jnp.pi * yy) ** 2)
    ones = jnp.ones((N, N))
    spai_rng = np.random.default_rng(5)
    spai_a = _tridiag(spai_rng, 16 * 16)
    return {
        "x": rng.standard_normal((N, N)),
        "v": rng.standard_normal((N, N)),
        "x3": rng.standard_normal((N_3D,) * 3),
        "r": rng.standard_normal((N, N)),
        "r3": rng.standard_normal((N_3D,) * 3),
        "c": c,
        "c2": np.asarray(2.0 + jnp.cos(3 * jnp.pi * xx) * yy),
        "b_aniso": np.asarray(gt.anisotropic_operator(N_ANISO, 0.05)(
            jnp.ones((N_ANISO, N_ANISO)))),
        "b_varcoef": np.asarray(gt.varcoef_operator(jnp.asarray(c))(ones)),
        "b3": np.asarray(gt.poisson3d_operator(N_3D)(jnp.ones((N_3D,) * 3))),
        "b_complex": np.asarray(gt.helmholtz_operator(N, KH2)(ones.astype(jnp.complex128))),
        "b_split": np.asarray(gt.complex_to_split(gt.helmholtz_operator(N, KH2)(
            (1.0 + 0.5j) * ones.astype(jnp.complex128)))),
        "b_poisson": np.asarray(gt.poisson_operator(N)(ones)),
        "b_cd": np.asarray(gt.convection_diffusion_operator(N, 0.4, 0.2)(ones)),
        "b_impl": np.random.default_rng(3).standard_normal((N_IMPL, N_IMPL)),
        "sketch": np.asarray(jax.random.normal(jax.random.PRNGKey(0), (12, N, N),
                                               jnp.float64)),
        "spai_a": spai_a,
        "spai_v": spai_rng.standard_normal((16, 16)),
    }


def _jax(world, cases):
    """gmres_tpu on the first ``world`` CPU devices, every case the worker
    runs."""
    mesh = solver_mesh(world)

    def put(a, spec=P("grid", None)):
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))

    def run(fn, *args):
        return jax.jit(fn)(*args)

    x, v = cases["x"], cases["v"]
    xc = x + 1j * v
    rows, rows3, stack = P("grid", None), P("grid", None, None), P(None, "grid", None)
    c = jnp.asarray(cases["c"])
    ops = {
        "poisson": (gt.poisson_operator(N), x, rows),
        "convdiff": (gt.convection_diffusion_operator(N, 0.4, 0.2), x, rows),
        "anisotropic": (gt.anisotropic_operator(N, 0.05), x, rows),
        "helmholtz": (gt.helmholtz_operator(N, KH2), x, rows),
        "helmholtz_complex": (gt.helmholtz_operator(N, KH2), xc, rows),
        "helmholtz_damped": (gt.helmholtz_operator(N, KH2, damping=0.3), xc, rows),
        "helmholtz_split": (gt.helmholtz_split_operator(N, KH2, damping=0.3),
                            np.stack([x, v]), stack),
        "poisson3d": (gt.poisson3d_operator(N_3D), cases["x3"], rows3),
        "varcoef": (gt.varcoef_operator(c), x, rows),
        "bratu": (gt.bratu_residual(N, 5.0), 0.1 * x, rows),
    }
    out = {}
    for name, (op, a, spec) in ops.items():
        out[f"op_{name}"] = np.asarray(run(op, put(a, spec)))
    for name in ("poisson", "convdiff"):
        op = ops[name][0]
        xs, vs = put(x), put(v)
        out[f"vjp_{name}"] = np.asarray(run(lambda p, q: jax.vjp(op, p)[1](q)[0], xs, vs))
        out[f"jvp_{name}"] = np.asarray(run(lambda p, q: jax.jvp(op, (p,), (q,))[1], xs, vs))
    r, rc = cases["r"], cases["r"] + 1j * v
    cycles = {
        "csl_complex": (csl_multigrid_preconditioner(N, KH2, mesh=mesh,
                                                     replicate_below=CSL_BELOW), rc, rows),
        "csl_split": (csl_multigrid_preconditioner(N, KH2, layout="split", mesh=mesh,
                                                   replicate_below=CSL_BELOW),
                      np.stack([rc.real, rc.imag]), stack),
        "poisson3d": (gt.poisson3d_multigrid_preconditioner(N_3D, mesh=mesh), cases["r3"],
                      rows3),
    }
    for name, (m, a, spec) in cycles.items():
        out[f"cycle_{name}"] = np.asarray(run(m, put(a, spec)))

    op = gt.anisotropic_operator(N_ANISO, 0.05)
    m = gt.anisotropic_multigrid_preconditioner(N_ANISO, 0.05)
    out["anisotropic"] = run(lambda b: gt.cg(op, b, tol=1e-8, M=m), put(cases["b_aniso"]))
    op, m = gt.varcoef_operator(c), gt.varcoef_multigrid_preconditioner(c)
    out["varcoef"] = run(lambda b: gt.cg(op, b, tol=1e-10, M=m), put(cases["b_varcoef"]))
    op = gt.poisson3d_operator(N_3D)
    m = gt.poisson3d_multigrid_preconditioner(N_3D, mesh=mesh)
    out["poisson3d"] = run(lambda b: gt.cg(op, b, tol=1e-9, max_iterations=300, M=m),
                           put(cases["b3"], rows3))
    op, m = gt.helmholtz_operator(N, KH2), csl_multigrid_preconditioner(N, KH2)
    out["complex"] = run(lambda b: gt.gmres(op, b, restart=60, tol=1e-8, variant="mgsr",
                                            M=m, max_restarts=30, compute_v_err=False,
                                            certify="true"), put(cases["b_complex"]))
    op = gt.helmholtz_split_operator(N, KH2)
    m = csl_multigrid_preconditioner(N, KH2, layout="split")
    out["split"] = run(lambda b: gt.gmres(op, b, restart=60, tol=1e-9, M=m, variant="mgsr",
                                          compute_v_err=False,
                                          max_restarts=worker.SPLIT_RESTARTS),
                       put(cases["b_split"], stack))
    poisson = gt.poisson_operator(N)
    p_defl = gt.coarse_space_preconditioner(poisson, gt.dirichlet_poisson_modes(N, 6))
    b = put(cases["b_poisson"])
    out["deflation"] = run(lambda bb: gt.cg(poisson, bb, tol=1e-10, M=p_defl), b)
    m_ny, lam = gt.nystrom_preconditioner(poisson, jnp.zeros((N, N)), rank=12)
    out["nystrom_lam"] = np.asarray(lam)
    out["nystrom"] = run(lambda bb: gt.cg(poisson, bb, tol=1e-9, M=m_ny), b)
    m_spai = gt.spai_preconditioner(jnp.asarray(cases["spai_a"]))
    out["spai"] = np.asarray(run(m_spai, put(cases["spai_v"])))
    out["newton"] = run(lambda u0: gt.newton_krylov(gt.bratu_residual(N, 5.0), u0, tol=1e-10),
                        put(np.zeros((N, N))))
    base = gt.poisson_operator(N_IMPL)

    def loss(theta, bb):
        xx = gt.implicit_solve(lambda th: (lambda w: base(w) + th * w), theta, bb,
                               solver=lambda o, rhs: gt.cg(o, rhs, tol=1e-12,
                                                           max_iterations=2000),
                               symmetric=True)
        return 0.5 * jnp.sum(xx * xx)

    g_theta, g_b = run(jax.grad(loss, argnums=(0, 1)), jnp.asarray(0.7), put(cases["b_impl"]))
    out["implicit_theta"], out["implicit_b"] = float(g_theta), np.asarray(g_b)
    lo, hi = gt.poisson_spectral_bounds(N)
    out["chebyshev"] = run(lambda bb: gt.chebyshev_solve(poisson, bb, lo, hi, order=16,
                                                         tol=1e-8, max_cycles=200), b)
    return out


WORLDS = (2, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: (port, jax, world)} for both world sizes. The two spawns run
    at once (their ranks mostly wait on messages) while gmres_tpu's side
    runs for each, the last world's in a process of its own beside the
    parent's."""
    cases = _cases()
    runs = {}
    try:
        for world in WORLDS:
            out_dir = tmp_path_factory.mktemp(f"dist_models_world{world}")
            runs[world] = (out_dir, mp.spawn(
                worker.run, args=(world, os.path.join(out_dir, "rendezvous"),
                                  str(out_dir), cases), nprocs=world, join=False))
        child = gmres_tpu_in_child(_jax, WORLDS[-1], cases)
        refs = {world: _jax(world, cases) for world in WORLDS[:-1]}
        refs[WORLDS[-1]] = child()
    finally:
        for _, ctx in runs.values():
            while not ctx.join():
                pass
    return {world: (_assembled(out_dir, world), refs[world], world)
            for world, (out_dir, _) in runs.items()}


@pytest.fixture(params=WORLDS, ids=lambda w: f"world{w}")
def dist_run(request, worlds):
    """(port, jax, world) at one world size."""
    return worlds[request.param]


def _counts(port, name):
    return tuple(int(v) for v in port[f"{name}_counts"])


OPERATORS = ["poisson", "convdiff", "anisotropic", "helmholtz", "helmholtz_complex",
             "helmholtz_damped", "helmholtz_split", "poisson3d", "varcoef", "bratu"]


@pytest.mark.parametrize("name", OPERATORS)
def test_plain_operator_on_a_sharded_grid(dist_run, name):
    """Every plain model operator on a row-sharded DTensor (the split stack
    on [Shard(1)]) is gmres_tpu's on the same mesh within 1e-13 relative,
    with no collective at all and one halo exchange."""
    port, ref, _ = dist_run
    assert rel_err(port[f"op_{name}"], ref[f"op_{name}"]) <= 1e-13
    assert tuple(port[f"op_{name}_comm"]) == (0, 0, 0)
    assert int(port[f"op_{name}_exchanges"]) == 1


def test_varcoef_apply_with_two_fields_in_turn(dist_run):
    """varcoef_apply with one coefficient field, then another, then the
    first again, on one sharded x: each result is the port's plain result
    for its own field on the whole grid within 1e-13 relative, with one
    exchange each (no halo form of one field serves another)."""
    import gmres_tpu_torch as tt

    port, _, _ = dist_run
    cases = _cases()
    x = torch.as_tensor(cases["x"])
    for key, field in (("c1", "c"), ("c2", "c2"), ("c1_again", "c")):
        plain = tt.varcoef_apply(torch.tensor(cases[field]), x).numpy()
        assert rel_err(port[f"varcoef_apply_{key}"], plain) <= 1e-13
        assert int(port[f"varcoef_apply_{key}_exchanges"]) == 1


@pytest.mark.parametrize("name", ["poisson", "convdiff"])
def test_vjp_and_jvp_of_plain_operators(dist_run, name):
    """torch.func.vjp of the plain operator on the sharded x (HaloStencil's
    transpose rule) and J·v through ``blockwise_jvp`` (its tangent rule on
    each rank's block) equal jax.vjp and jax.jvp within 1e-12, each with no
    collective and two exchanges (the primal and the rule)."""
    port, ref, _ = dist_run
    for kind in ("vjp", "jvp"):
        assert rel_err(port[f"{kind}_{name}"], ref[f"{kind}_{name}"]) <= 1e-12
        assert tuple(port[f"{kind}_{name}_comm"]) == (0, 0, 0)
        assert int(port[f"{kind}_{name}_exchanges"]) == 2


@pytest.mark.parametrize("name", ["csl_complex", "csl_split", "poisson3d"])
def test_mesh_cycle(dist_run, name):
    """One application of the CSL (complex, split) and 3-D mesh= cycles: the
    port's mesh=None cycle within 1e-13 relative, gmres_tpu's mesh= cycle
    on the same mesh within 1e-12, one all-gather and no other collective."""
    port, ref, _ = dist_run
    z = port[f"cycle_{name}"]
    assert rel_err(z, port[f"cycle_{name}_plain"]) <= 1e-13
    assert rel_err(z, ref[f"cycle_{name}"]) <= 1e-12
    replicate_from, levels = (int(v) for v in port[f"cycle_{name}_levels"])
    assert replicate_from < levels
    assert tuple(port[f"cycle_{name}_comm"]) == (1, 0, 1)
    assert int(port[f"cycle_{name}_exchanges"]) > 0


@pytest.mark.parametrize("name,tol", [
    ("anisotropic", 1e-10),   # tests/test_anisotropic.py:92
    ("varcoef", 1e-10),       # tests/test_varcoef.py:104
    ("deflation", 1e-10),     # tests/test_deflation.py:141
    ("nystrom", 1e-10),       # tests/test_nystrom.py:91
    ("nystrom_sharded", 1e-10),
])
def test_cg_with_a_preconditioner_on_a_sharded_b(dist_run, name, tol):
    """CG on a sharded b with the anisotropic line cycle, the varcoef cycle,
    deflation with 6 Dirichlet modes and Nyström rank 12 (gmres_tpu's
    sketch; "nystrom_sharded" is built on a sharded x_like, the sketch's
    rows sharded): iterations equal to gmres_tpu's, x within the test's
    bound."""
    port, ref, _ = dist_run
    r = ref[name.replace("_sharded", "")]
    it, _, status = _counts(port, name)
    assert status == int(r.status) == 0
    assert it == int(r.iterations)
    np.testing.assert_allclose(port[f"{name}_x"], np.asarray(r.x), atol=tol)


@pytest.mark.parametrize("name", ["anisotropic", "varcoef"])
def test_mesh_none_cycles_gather_at_their_restriction(dist_run, name):
    """The anisotropic and varcoef cycles have no mesh= form in either
    package: on a sharded r their operators take the halo route and their
    line solves and weights stay local, and the one communication besides
    the exchanges is DTensor's own at the first restriction (its two
    strided row slices, two all-gathers; the levels below are
    replicated)."""
    port, _, _ = dist_run
    assert tuple(port[f"{name}_cycle_comm"]) == (2, 0, 2)
    assert int(port[f"{name}_cycle_exchanges"]) > 0


def test_nystrom_eigenvalues(dist_run):
    """λ̂ of the plain and of the sharded build agree with gmres_tpu's
    (the same sketch) to 1e-10 relative."""
    port, ref, _ = dist_run
    for key in ("nystrom_lam", "nystrom_lam_sharded"):
        np.testing.assert_allclose(port[key], ref["nystrom_lam"], rtol=1e-10)


def test_deflation_all_reduces(dist_run):
    """Each deflation application is two all-reduces (Wᵀr and (AW)ᵀz) beside
    CG's two an iteration; nothing else is communicated."""
    port, _, _ = dist_run
    it, _, _ = _counts(port, "deflation")
    gathers, reduces, total = (int(v) for v in port["deflation_comm"])
    assert gathers == 0 and total == reduces
    assert reduces == 4 * it + 4


def test_poisson3d_with_the_mesh_cycle(dist_run):
    """tests/test_poisson3d.py:89: CG with the 3-D mesh= cycle on a b sharded
    along its first axis converges within 1 iteration of gmres_tpu's."""
    port, ref, _ = dist_run
    it, _, status = _counts(port, "poisson3d")
    assert status == int(ref["poisson3d"].status) == 0
    assert abs(it - int(ref["poisson3d"].iterations)) <= 1


def test_complex_csl_gmres(dist_run):
    """tests/test_complex.py:108: MGSR GMRES(60) on the complex Helmholtz
    operator with the CSL cycle (here its mesh= form) converges within one
    restart of gmres_tpu's."""
    port, ref, _ = dist_run
    _, rst, status = _counts(port, "complex")
    assert status == int(ref["complex"].status) == 0
    assert abs(rst - int(ref["complex"].restarts)) <= 1


def test_split_csl_gmres(dist_run):
    """tests/test_helmholtz_split.py:81 on a [Shard(1)] stack with the split
    cycle (here its mesh= form): iterations, restarts and status equal to
    the replicated run's and to gmres_tpu's on its sharded stack. The cap
    is SPLIT_RESTARTS cycles: at 64² neither package reaches tol 1e-9
    (gmres_tpu runs to its test's 50-cycle cap). The test's x bound (1e-10
    against the replicated run) holds in gmres_tpu only because its sharded
    and replicated programs round alike: this iteration is chaotic, and the
    replicated run on b·(1 + 1e-15) moves x by ~1e-4 (held here), so the
    sharded x, whose sums round in another order, is held to within ten
    times that move of the replicated x."""
    port, ref, _ = dist_run
    r = ref["split"]
    counts = _counts(port, "split")
    assert counts == (int(r.iterations), int(r.restarts), int(r.status))
    assert counts == _counts(port, "split_replicated") == _counts(port, "split_perturbed")
    move = np.max(np.abs(port["split_perturbed_x"] - port["split_replicated_x"]))
    assert move > 1e-6
    assert np.max(np.abs(port["split_x"] - port["split_replicated_x"])) <= 10 * move


def test_spai_apply(dist_run):
    """tests/test_spai.py:140: M v on a sharded v is gmres_tpu's within 1e-12
    and the port's replicated apply; one all-gather of v and nothing else."""
    port, ref, _ = dist_run
    np.testing.assert_allclose(port["spai"], ref["spai"], atol=1e-12)
    np.testing.assert_allclose(port["spai"], port["spai_plain"], atol=1e-12)
    assert tuple(port["spai_comm"]) == (1, 0, 1)


def test_newton_krylov(dist_run):
    """tests/test_newton_krylov.py:123: Bratu 64², λ 5, from a sharded
    zero: gmres_tpu's Newton steps, x within 1e-9; J·v on each rank's block
    is two exchanges."""
    port, ref, _ = dist_run
    r = ref["newton"]
    it, _, status = _counts(port, "newton")
    assert status == int(r.status) == 0
    assert it == int(r.iterations)
    np.testing.assert_allclose(port["newton_x"], np.asarray(r.x), atol=1e-9)
    assert int(port["newton_exchanges"]) >= 2 * int(port["newton_jv"])


def test_implicit_gradients(dist_run):
    """tests/test_implicit.py:157: ∂L/∂θ and ∂L/∂b through the adjoint solve
    on a sharded b match gmres_tpu's within 1e-10 (θ relative, b absolute);
    the gradient of b comes back with b's shape."""
    port, ref, _ = dist_run
    np.testing.assert_allclose(float(port["implicit_theta"]), ref["implicit_theta"],
                               rtol=1e-10)
    assert port["implicit_b"].shape == (N_IMPL, N_IMPL)
    np.testing.assert_allclose(port["implicit_b"], ref["implicit_b"], atol=1e-10)


def test_polynomial_application(dist_run):
    """tests/test_polynomial.py:68: a degree-12 application on a sharded b
    has no all-reduce and no all-gather, one exchange an operator
    application (12), and is the replicated application within 1e-13."""
    port, _, _ = dist_run
    assert tuple(port["poly_comm"]) == (0, 0, 0)
    assert int(port["poly_exchanges"]) == 12
    assert rel_err(port["poly"], port["poly_plain"]) <= 1e-13


def test_chebyshev_solve_one_reduction_a_cycle(dist_run):
    """tests/test_chebyshev_solve.py:72: one all-reduce a cycle (and one for
    the initial residual), no other collective; gmres_tpu's and the plain
    run's cycle count."""
    port, ref, _ = dist_run
    it, _, status = _counts(port, "chebyshev")
    assert status == int(ref["chebyshev"].status) == 0
    assert it == int(ref["chebyshev"].iterations)
    assert _counts(port, "chebyshev") == tuple(int(v) for v in port["chebyshev_plain"])
    assert tuple(port["chebyshev_comm"]) == (0, it + 1, it + 1)


# ---------------------------------------------------------------------------
# In this process, on a one-rank gloo mesh.
# ---------------------------------------------------------------------------


def _wrappers():
    from gmres_tpu_torch.ops import fused, sparse, stencil, stencil_rdma

    dia = sparse.DIAMatrix(data=torch.ones((1, 16), dtype=torch.float64), offsets=(0,),
                           shape=(16, 16))
    bsr = sparse.BSRMatrix(data=torch.ones((4, 1, 4, 4), dtype=torch.float64),
                           block_cols=torch.zeros((4, 1), dtype=torch.int32), shape=(16, 16))
    return {
        "stencil5_cuda": lambda x: stencil.stencil5_cuda(x),
        "stencil_5pt_pallas_halo": lambda x: stencil.stencil_5pt_pallas_halo(x, None, None),
        "residual_restrict_cuda": lambda x: stencil.residual_restrict_cuda(x, x),
        "correct_residual_cuda": lambda x: stencil.correct_residual_cuda(x, x, x),
        "stencil5_dd_cuda": lambda x: stencil.stencil5_dd_cuda(x, x),
        "chebk_cuda": lambda x: fused.chebk_cuda(x, 1.0, [0.0, 1.0]),
        "cheb2_cuda": lambda x: fused.cheb2_cuda(x, None, None, 4.2, 0.2),
        "cg_fused_update_cuda": lambda x: fused.cg_fused_update_cuda(x, x, x, x, 0.5),
        "axpy_dot_cuda": lambda x: fused.axpy_dot_cuda(0.5, x, x, x),
        "dia_spmv_cuda": lambda x: sparse.dia_spmv_cuda(dia, x),
        "bsr_spmv_cuda": lambda x: sparse.bsr_spmv_cuda(bsr, x),
        "rdma_interior_cuda": lambda x: stencil_rdma.rdma_interior_cuda(x, [0.0] * 7),
    }


@pytest.mark.parametrize("wrapper", sorted(_wrappers()))
def test_kernel_wrappers_refuse_a_dtensor(tmp_path, wrapper):
    """No kernel wrapper takes a DTensor: each raises TypeError naming the
    DTensor before its device check (a CUDA DTensor's data_ptr() is 0),
    never gathering it or computing on the CPU instead; K1's message names
    the halo route, K2's ROADMAP item 8.6b."""
    import gmres_tpu_torch as tt
    from gmres_tpu_torch.ops import _cuda

    with one_rank_mesh(str(tmp_path)) as mesh:
        x = tt.shard_grid_vector(torch.ones((16, 16), dtype=torch.float64), mesh)
        assert x.data_ptr() == 0
        with pytest.raises(TypeError, match="DTensor") as err:
            _wrappers()[wrapper](x)
        if wrapper == "stencil5_cuda":
            assert "halo route" in str(err.value)
        if wrapper == "chebk_cuda":
            assert "8.6b" in str(err.value)
        with pytest.raises(TypeError, match="halo route"):
            _cuda.check_grid("stencil5_cuda", "K1", x)


def test_dtensor_route_placements(tmp_path):
    """The DTensor route by placement: [Replicate()] is the plain
    computation on the local tensor; a column-sharded grid raises
    NotImplementedError naming ROADMAP item 8.5, with nothing gathered."""
    import gmres_tpu_torch as tt
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    x = torch.as_tensor(np.random.default_rng(4).standard_normal((16, 16)))
    op = tt.poisson_operator(16)
    with one_rank_mesh(str(tmp_path)) as mesh:
        rep = distribute_tensor(x, mesh, [Replicate()])
        y = op(rep)
        assert tuple(y.placements) == (Replicate(),)
        assert torch.equal(y.to_local(), op(x))
        cols = distribute_tensor(x, mesh, [Shard(1)])
        with CommDebugMode() as comm, pytest.raises(NotImplementedError, match="8.5"):
            op(cols)
        assert comm.get_total_counts() == 0


def test_blockwise_mode_takes_rank_blocks_only(tmp_path):
    """Inside blockwise_jvp a plain tensor is a rank's block: a stencil on a
    tensor of another shape raises ValueError, and after the call a plain
    tensor takes the plain route again."""
    import gmres_tpu_torch as tt
    from gmres_tpu_torch.ops.stencil import on_sharded_grid
    from gmres_tpu_torch.parallel.halo import blockwise_jvp

    rng = np.random.default_rng(6)
    x, v = (torch.as_tensor(rng.standard_normal((16, 16))) for _ in range(2))
    op = tt.poisson_operator(16)
    with one_rank_mesh(str(tmp_path)) as mesh:
        xs, vs = tt.shard_grid_vector(x, mesh), tt.shard_grid_vector(v, mesh)
        jv = blockwise_jvp(op, xs, vs)
        assert rel_err(jv.full_tensor().numpy(), op(v).numpy()) <= 1e-15
        with pytest.raises(ValueError, match="rank's block"):
            blockwise_jvp(lambda u: op(u[:8]), xs, vs)
    assert not on_sharded_grid(x)
    assert torch.equal(op(x), tt.poisson_operator(16)(x))
