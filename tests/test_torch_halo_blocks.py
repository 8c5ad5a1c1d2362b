"""The block form of the halo route, the distributed V-cycles and the sparse
operators' rank rows against gmres_tpu's ``jax.vmap`` of the same
operators, at 1, 2 and 4 ranks, and the lane forms of the plain versions.

A block of s rows of a row-sharded grid (a (s, N, N) DTensor placed
``[Shard(1)]``) goes through ``ops/blas.py:row_apply`` as gmres_tpu's block
solvers ``jax.vmap`` an operator: one halo exchange of the s rows' boundary
rows and one application (one launch of K1's halo form, K5 or K8 on the
card). Each world size is one spawn of gloo processes on the CPU
(tests/torch_halo_worker.py:run_blocks), the three spawns started together
while the parent runs gmres_tpu on the same numpy inputs:

* every halo-route operator of the port on a (3, 32, 32) float64 block
  (the halo operator with the Laplacian and with general coefficients,
  cbpr2 and the order-4 Chebyshev preconditioner, the plain Poisson
  operator, the complex Helmholtz operator, the split Helmholtz operator
  on a (3, 2, 32, 32) block of stacks (its grid rows the third axis), the
  7-point stencil on a (3, 8, 8, 8) block and the variable-coefficient
  operator: the plain forms' halo route) against ``jax.vmap`` of
  gmres_tpu's operator on the 8-device mesh to 1e-13 relative (the
  operator tolerance of tests/test_torch_halo.py), and the RDMA operators
  on a (3, 16, 16) float32 block against ``jax.vmap`` of gmres_tpu's RDMA
  route in interpret mode on a mesh of as many devices as ranks (1e-6
  relative, tests/test_torch_halo.py's float32 bound: XLA:CPU may contract
  the interpret-mode products and sums);
* each row bitwise the port's own call on that row;
* the kernel entries (K1's halo form, K5, K8) called as often as for one
  row, never on a vmap-batched block;
* the halo exchanges of a block application equal to one row's
  application (1; 3 for the order-4 Chebyshev, one a sweep);
* block CG (halo operator, halo cbpr2) and LOBPCG (halo operator, halo
  cbpr2 as M) on sharded blocks: gmres_tpu's counts and status, X to 1e-9
  relative and the eigenvalues to rtol 1e-9 (tests/test_torch_dist.py's
  and tests/test_torch_dist_spectral.py's solver tolerances);
* in the same spawns (tests/torch_dist_blocks_worker.py): every ``mesh=``
  cycle (Poisson; convection–diffusion with its Chebyshev, Jacobi and
  red-black smoothers; Helmholtz SPD; CSL split on (3, 2, 32, 32) blocks
  and complex; 3-D on (3, 8, 8, 8)), with ``replicate_below`` at its
  default and set so that a level is replicated, and the ``mesh=None``
  Poisson cycle on a DTensor block, against ``jax.vmap`` of gmres_tpu's
  ``mesh=`` cycle (default ``replicate_below``: where the levels are
  replicated moves data, not arithmetic) on the 8-device mesh within 1e-13
  relative (tests/test_multigrid.py:123's bound); ``sparse_operator`` of
  every format of tests/test_torch_dist_sparse.py (its wide-band DIA a
  five-diagonal one, offsets 0, ±1, ±200) on a (3, 256) block against
  ``jax.vmap`` of gmres_tpu's, within that test's 1e-13; each row bitwise
  its own call, a block's halo exchanges, all-gathers and collectives one
  row's (one all-gather exactly where a level is replicated or a format
  gathers); block CG with the ``mesh=`` Poisson cycle, LOBPCG (k 4) with
  the ``mesh=None`` cycle and block CG with cbpr2 on the sharded HYB
  operator held to gmres_tpu's counts and status, X to 1e-9 and the
  eigenvalues to rtol 1e-9.

The lane forms of the plain versions (K1's halo form, K5, K8's interior
and edges) run in-process: a (lanes, rows, N) block with random per-lane
halo rows, and with a side or both null, is bitwise each lane's own call.
So do, on a one-rank gloo mesh, vmap of a halo-route operator over a plain
block (the rank's own rows: one exchange); the operators that have no
block form (the Nyström and deflation applications, a composition with
one, an operator of the caller's own), which ``row_apply`` applies row by
row because they are not marked as taking the block whole
(``ops/blas.py:row_blocks``), the first two raising NotImplementedError
under a vmap of their own; and the sparse operators, the distributed
V-cycles and a composition with one, which are marked and take the block
whole.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import gmres_tpu as gt
from torch.distributed.tensor import Shard, distribute_tensor
from gmres_tpu.models.convection_diffusion import convection_diffusion_coefs
from gmres_tpu.ops import sparse as jsp
from gmres_tpu.parallel.halo import (
    halo_chebyshev_preconditioner,
    halo_poisson_operator,
    halo_stencil_operator,
    rdma_chebyshev_preconditioner,
    rdma_stencil_operator,
)
from gmres_tpu.parallel.mesh import solver_mesh
from gmres_tpu.precond.multigrid import csl_multigrid_preconditioner
from gmres_tpu_torch.ops import fused as tfu
from gmres_tpu_torch.ops import stencil as tst
from gmres_tpu_torch.ops import stencil_rdma as trd
from tests import torch_dist_blocks_worker as cycle_worker
from tests import torch_halo_worker as worker
from tests.test_torch_dist_sparse import _cases as sparse_cases
from tests.test_torch_dist_sparse import _to_jax
from tests.torch_parity import assembled, rel_err, seeded

WORLDS = (1, 2, 4)
S = 3
F64_ROUTES = ("poisson", "general", "cbpr2", "cheb4", "plain_poisson",
              "helmholtz_complex", "helmholtz_split", "poisson3d", "varcoef")
RDMA_ROUTES = ("rdma", "rdma_asym", "rdma_cbpr2")
# Halo exchanges of one application, a row's and a block's alike.
EXCHANGES = {"cheb4": 3}
# Kernel entry calls of one application (K1's halo form, K5, K8; the
# complex, 7-point and variable-coefficient halo forms are plain torch).
ENTRIES = {"cheb4": 3, "helmholtz_split": 2, "helmholtz_complex": 0, "poisson3d": 0,
           "varcoef": 0}


def _cases():
    n, n3 = worker.N_BLOCK, worker.N_3D
    return {
        "blk": seeded(950, (S, n, n)),
        "blk_rdma": seeded(951, (S, worker.N_RDMA_BLOCK, worker.N_RDMA_BLOCK)).astype(
            np.float32),
        "blk_complex": seeded(952, (S, n, n)) + 1j * seeded(953, (S, n, n)),
        "blk_split": seeded(957, (S, 2, n, n)),
        "blk_3d": seeded(954, (S, n3, n3, n3)),
        "c_varcoef": 1.0 + np.random.default_rng(958).random((n, n)),
        "coefs": convection_diffusion_coefs(0.4, 0.2),
        "coefs_asym": convection_diffusion_coefs(0.7, 0.3),
        "B_cg": seeded(955, (S, n, n)),
        "lobpcg_x0": np.random.default_rng(956).standard_normal((4, n, n)),
        "cycle_blocks": _cycle_cases(),
    }


def _jax_routes(cases, mesh, rdma_mesh):
    """gmres_tpu's operator for each route, and the mesh its block lies on."""
    n = worker.N_BLOCK
    return {
        "poisson": (halo_poisson_operator(mesh), mesh),
        "general": (halo_stencil_operator(mesh, cases["coefs"]), mesh),
        "cbpr2": (halo_chebyshev_preconditioner(mesh, 0.2, 8.2), mesh),
        "cheb4": (halo_chebyshev_preconditioner(mesh, 0.2, 8.2, order=4), mesh),
        "plain_poisson": (gt.poisson_operator(n), mesh),
        "helmholtz_complex": (gt.helmholtz_operator(n, worker.KH2, damping=0.2), mesh),
        "helmholtz_split": (gt.helmholtz_split_operator(n, worker.KH2, damping=0.2), mesh),
        "poisson3d": (gt.poisson3d_operator(worker.N_3D), mesh),
        "varcoef": (gt.varcoef_operator(jnp.asarray(cases["c_varcoef"])), mesh),
        "rdma": (rdma_stencil_operator(rdma_mesh, interpret=True), rdma_mesh),
        "rdma_asym": (rdma_stencil_operator(rdma_mesh, cases["coefs_asym"],
                                            interpret=True), rdma_mesh),
        "rdma_cbpr2": (rdma_chebyshev_preconditioner(rdma_mesh, 0.2, 8.2,
                                                     interpret=True), rdma_mesh),
    }


def _block(a, mesh, dim=1):
    """a placed on mesh with its grid rows, axis dim, along "grid"."""
    spec = [None] * a.ndim
    spec[dim] = "grid"
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(*spec)))


def _jax(cases):
    """gmres_tpu's side: jax.vmap of every route (the float64 ones on the
    8-device mesh, the RDMA ones on 1, 2 and 4 devices), block CG and
    LOBPCG on the 8-device mesh."""
    mesh = solver_mesh(8)
    ref = {}
    for world in WORLDS:
        rdma_mesh = solver_mesh(world)
        for name, (op, on) in _jax_routes(cases, mesh, rdma_mesh).items():
            if name in F64_ROUTES and world != WORLDS[0]:
                continue
            key = {"helmholtz_complex": "blk_complex", "helmholtz_split": "blk_split",
                   "poisson3d": "blk_3d"}.get(name, "blk_rdma" if name in RDMA_ROUTES else "blk")
            dim = 1 + (name in worker.SPLIT_ROUTES)
            out = np.asarray(jax.vmap(op)(_block(cases[key], on, dim)))
            # The rows along axis 1, as the worker writes them.
            out = np.moveaxis(out, dim, 1)
            ref[name if name in F64_ROUTES else f"{name}_world{world}"] = out
    op = halo_poisson_operator(mesh)
    m = halo_chebyshev_preconditioner(mesh, 0.2, 8.2)
    ref["block_cg"] = jax.jit(lambda b: gt.block_cg(op, b, tol=1e-9, M=m))(
        _block(cases["B_cg"], mesh))
    ref["lobpcg"] = gt.lobpcg(op, _block(cases["lobpcg_x0"], mesh), tol=1e-8,
                              max_iterations=100, M=m)
    ref.update(_cycle_jax(cases["cycle_blocks"], mesh))
    return ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: the port's outputs}, and gmres_tpu's side."""
    cases = _cases()
    runs = {}
    try:
        for world in WORLDS:
            out_dir = tmp_path_factory.mktemp(f"halo_blocks_world{world}")
            runs[world] = (out_dir, mp.spawn(
                worker.run_blocks, args=(world, os.path.join(out_dir, "rendezvous"),
                                         str(out_dir), cases), nprocs=world, join=False))
        ref = _jax(cases)
    finally:
        for _, ctx in runs.values():
            while not ctx.join():
                pass
    return {world: assembled(out_dir, world) for world, (out_dir, _) in runs.items()}, ref


@pytest.fixture(params=WORLDS, ids=lambda w: f"world{w}")
def run(request, worlds):
    """(world, the port's outputs, gmres_tpu's)."""
    ports, ref = worlds
    return request.param, ports[request.param], ref


@pytest.mark.parametrize("name", F64_ROUTES + RDMA_ROUTES)
def test_block_application_matches_jax_vmap(run, name):
    """A block application of each route: gmres_tpu's jax.vmap of the same
    operator within the stated bound, each row bitwise the port's own call
    on it, the block's placement (its grid rows sharded), the exchanges of
    one row's application, and the kernel entry calls of one row's, none
    of them on a vmap-batched block (which the card could not launch)."""
    world, port, ref = run
    want = ref[name] if name in F64_ROUTES else ref[f"{name}_world{world}"]
    got = port[name]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_err(got, want) < (1e-13 if name in F64_ROUTES else 1e-6)
    assert bool(port[f"{name}_bitwise"])
    dim = 1 + (name in worker.SPLIT_ROUTES)
    assert str(port[f"{name}_placements"]) == f"(Shard(dim={dim}),)"
    block, row = port[f"{name}_exchanges"]
    assert block == row == EXCHANGES.get(name, 1)
    calls, batched, row_calls = port[f"{name}_entries"]
    assert calls == row_calls == ENTRIES.get(name, 1) and batched == 0


def test_block_cg_on_the_halo_route_matches_jax(run):
    """Block CG with the halo operator and the halo cbpr2 on a sharded
    (3, 32, 32) block: gmres_tpu's iterations and status, X to 1e-9
    relative; one exchange an application of A or M to the block (two an
    iteration, with the setup's and the certification's)."""
    _, port, ref = run
    r = ref["block_cg"]
    iterations, status = port["block_cg_counts"]
    assert status == int(r.status) == 0
    assert iterations == int(r.iterations)
    assert rel_err(port["block_cg_x"], np.asarray(r.x)) < 1e-9
    assert int(port["block_cg_exchanges"]) <= 2 * iterations + 4


def test_lobpcg_on_the_halo_route_matches_jax(run):
    """LOBPCG (k 4) with the halo operator and the halo cbpr2 as M on a
    sharded block: gmres_tpu's iterations and status, eigenvalues to rtol
    1e-9."""
    _, port, ref = run
    r = ref["lobpcg"]
    iterations, status = port["lobpcg_counts"]
    assert status == 0 and bool(r.converged)
    assert iterations == int(r.iterations)
    np.testing.assert_allclose(port["lobpcg_eigenvalues"], np.asarray(r.eigenvalues),
                               rtol=1e-9)


# ---------------------------------------------------------------------------
# The distributed V-cycles and the sparse operators' rank rows on a sharded
# block (tests/torch_dist_blocks_worker.py, in the same spawns).
# ---------------------------------------------------------------------------

N, N_3D, KH2 = cycle_worker.N, cycle_worker.N_3D, cycle_worker.KH2
CYCLES = [f"{name}_{setting}" for name in cycle_worker.CYCLES for setting in cycle_worker.BELOW]
CYCLES.append("poisson_none")
SPARSE = ("csr", "coo", "ell", "dia", "hyb", "hyb_residue", "bsr_band", "bsr_wide",
          "dia_wide")
# The formats that gather x whole (one all-gather), on more than one rank;
# the others exchange their band (one exchange). On one rank every band fits.
GATHERED = ("csr", "coo", "ell", "hyb_residue", "bsr_wide", "dia_wide")


def _cycle_cases():
    """The numpy inputs of tests/torch_dist_blocks_worker.py's cases, blocks
    of S rows."""
    r = seeded(990, (S, N, N))
    return {
        "r": r,
        "r_split": np.stack([r, seeded(991, (S, N, N))], axis=1),
        "r_complex": r + 1j * seeded(991, (S, N, N)),
        "r3": seeded(992, (S, N_3D, N_3D, N_3D)),
        "sparse": sparse_cases(),
        "wide_band": sum(np.diag(seeded(997 + k, (256 - abs(off),)), off)
                         for k, off in enumerate((-200, -1, 0, 1, 200))),
        "x_flat": seeded(993, (S, 256)),
        "probes": {m: np.asarray(jax.random.normal(jax.random.PRNGKey(0), (m, m),
                                                   jnp.float64)) for m in (N, N // 2)},
        "B_cg": seeded(994, (S, N, N)),
        "lobpcg_x0": np.random.default_rng(995).standard_normal((4, N, N)),
        "B_flat": seeded(996, (S, 256)),
    }


def _jax_cycle(name, mesh):
    """gmres_tpu's ``mesh=`` cycle ``name`` (default ``replicate_below``)."""
    if name == "poisson":
        return gt.poisson_multigrid_preconditioner(N, mesh=mesh)
    if name.startswith("convdiff_"):
        return gt.convection_diffusion_multigrid_preconditioner(
            N, 0.4, 0.2, smoother=name[len("convdiff_"):], mesh=mesh)
    if name == "helmholtz":
        return gt.helmholtz_shifted_laplacian_preconditioner(N, KH2, mesh=mesh)
    if name.startswith("csl_"):
        return csl_multigrid_preconditioner(N, KH2, layout=name[len("csl_"):], mesh=mesh)
    return gt.poisson3d_multigrid_preconditioner(N_3D, mesh=mesh)


def _cycle_jax(cases, mesh):
    """gmres_tpu's side of the cycle and sparse cases on the 8-device mesh:
    jax.vmap of every mesh= cycle (``cycle_…``) and sparse operator, the
    two block CG solves and LOBPCG."""
    ref = {}
    for name, (key, dim) in cycle_worker.CYCLES.items():
        out = np.asarray(jax.jit(jax.vmap(_jax_cycle(name, mesh)))(
            _block(cases[key], mesh, dim)))
        # The rows along axis 1, as the worker writes them.
        ref[f"cycle_{name}"] = np.moveaxis(out, dim, 1)
    x = _block(cases["x_flat"], mesh)
    for name, a in cycle_worker.sparse_matrices(cases).items():
        op = jsp.sparse_operator(_to_jax(a))
        ref[f"sparse_{name}"] = np.asarray(jax.jit(jax.vmap(op))(x))
    ref["block_cg_mg"] = jax.jit(lambda b: gt.block_cg(
        gt.poisson_operator(N), b, tol=1e-9,
        M=gt.poisson_multigrid_preconditioner(N, mesh=mesh)))(_block(cases["B_cg"], mesh))
    ref["lobpcg_mg"] = gt.lobpcg(gt.poisson_operator(N), jnp.asarray(cases["lobpcg_x0"]),
                                 tol=1e-8, max_iterations=100,
                                 M=gt.poisson_multigrid_preconditioner(N))
    op = jsp.sparse_operator(_to_jax(cycle_worker.sparse_matrices(cases)["hyb"]))
    ref["block_cg_hyb"] = jax.jit(lambda b: gt.block_cg(
        op, b, tol=1e-9, M=gt.chebyshev_preconditioner(op, 0.2, 8.2)))(
        _block(cases["B_flat"], mesh))
    return ref


def _held(port, key, want, tol):
    """The block form of ``key``: marked, gmres_tpu's output within tol,
    each row bitwise its own call, and one row's exchanges, all-gathers and
    collectives; returns (exchanges, all-gathers, collectives)."""
    got = port[key]
    assert bool(port[f"{key}_marked"])
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_err(got, want) < tol
    assert bool(port[f"{key}_bitwise"])
    block, row = port[f"{key}_comm"]
    assert tuple(block) == tuple(row)
    return tuple(int(v) for v in block)


@pytest.mark.parametrize("name", CYCLES)
def test_cycle_block_matches_jax_vmap(run, name):
    """One row_apply of each distributed cycle to a sharded block: jax.vmap
    of gmres_tpu's mesh= cycle within 1e-13 relative, each row bitwise its
    own call, the grid rows still sharded, one row's exchanges, and one
    all-gather exactly where a level is replicated (no other collective)."""
    _, port, ref = run
    cycle = name.rsplit("_", 1)[0]
    exchanges, gathers, collectives = _held(port, name, ref[f"cycle_{cycle}"], 1e-13)
    dim = 1 + (cycle == "csl_split")
    assert str(port[f"{name}_placements"]) == f"(Shard(dim={dim}),)"
    assert collectives == gathers
    if name != "poisson_none":
        replicate_from, levels = (int(v) for v in port[f"{name}_levels"])
        assert gathers == int(replicate_from < levels)
        assert exchanges > 0 or replicate_from == 0
        if name.endswith("_replicated"):
            assert replicate_from < levels


@pytest.mark.parametrize("name", SPARSE)
def test_sparse_block_matches_jax_vmap(run, name):
    """One row_apply of each format's sparse operator to a sharded (3, 256)
    block: jax.vmap of gmres_tpu's sparse_operator within 1e-13 relative,
    each row bitwise its own application, and one row's collectives: one
    exchange of the band, or one all-gather of x."""
    world, port, ref = run
    key = f"sparse_{name}"
    exchanges, gathers, collectives = _held(port, key, ref[key], 1e-13)
    assert str(port[f"{key}_placements"]) == "(Shard(dim=1),)"
    assert collectives == gathers
    gathered = name in GATHERED and (world > 1 or name not in ("bsr_wide", "dia_wide"))
    assert (exchanges, gathers) == ((0, 1) if gathered else (1, 0))


@pytest.mark.parametrize("name", ["block_cg_mg", "lobpcg_mg", "block_cg_hyb"])
def test_block_solvers_with_block_forms(run, name):
    """Block CG with the mesh= Poisson cycle, LOBPCG with the mesh=None
    cycle and block CG with cbpr2 on the HYB operator, each on a sharded
    block: gmres_tpu's iterations and status, X to 1e-9 or the eigenvalues
    to rtol 1e-9."""
    _, port, ref = run
    r = ref[name]
    iterations, status = (int(v) for v in port[f"{name}_counts"])
    assert status == 0
    assert iterations == int(r.iterations)
    if name == "lobpcg_mg":
        assert bool(r.converged)
        np.testing.assert_allclose(port[f"{name}_eigenvalues"], np.asarray(r.eigenvalues),
                                   rtol=1e-9)
    else:
        assert int(r.status) == 0
        np.testing.assert_allclose(port[f"{name}_x"], np.asarray(r.x), atol=1e-9)


# ---------------------------------------------------------------------------
# The lane forms of the plain versions (the CPU's route, the card's oracle).
# ---------------------------------------------------------------------------

SIDES = ("both", "top", "bottom", "none")


def _lanes(dtype, sides, shape=(4, 12, 9)):
    lanes, _, cols = shape
    x = torch.as_tensor(seeded(960, shape)).to(dtype)
    top = torch.as_tensor(seeded(961, (lanes, 1, cols))).to(dtype)
    bot = torch.as_tensor(seeded(962, (lanes, 1, cols))).to(dtype)
    return (x, top if sides in ("both", "top") else None,
            bot if sides in ("both", "bottom") else None)


def _lane(h, i):
    return None if h is None else h[i]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sides", SIDES)
@pytest.mark.parametrize("form", ["K1 halo", "K5", "K8"])
def test_lane_forms_of_the_plain_versions(form, sides, dtype):
    """A (lanes, rows, N) block with per-lane halo rows (random, or a side
    or both None) through each plain lane form, and through the routed
    entry a CPU block takes, is bitwise each lane's own call."""
    x, top, bot = _lanes(dtype, sides)
    coefs = (4.3, -1.2, -0.7, -1.9, -0.1)
    if form == "K1 halo":
        def apply(xb, t, b):
            return tst.stencil_5pt_halo(xb, t, b, coefs)

        routed = tst.stencil_5pt_pallas_halo(x, top, bot, coefs)
    elif form == "K5":
        scal = tfu.cheb2_scalars(*tfu.chebyshev_ref_scalars(0.2, 8.2), coefs, dtype)

        def apply(xb, t, b):
            return tfu.cheb2_plain(xb, t, b, scal)

        routed = tfu.cheb2_apply(x, top, bot, scal)
    else:
        d, alpha = tfu.chebyshev_ref_scalars(0.2, 8.2)
        c = trd._coefs7((*coefs, 1.0 / d + alpha, -alpha / d), dtype)

        def apply(xb, t, b):
            return trd.rdma_edges_plain(trd.rdma_interior_plain(xb, c), t, b, c)

        routed = apply(x, top, bot)
    block = apply(x, top, bot)
    singles = torch.stack([apply(x[i], _lane(top, i), _lane(bot, i))
                           for i in range(x.shape[0])])
    assert torch.equal(block, singles)
    assert torch.equal(routed, singles)


# ---------------------------------------------------------------------------
# In one process, on a one-rank gloo mesh: a vmapped plain block (the
# rank's own rows) and the operators that go row by row.
# ---------------------------------------------------------------------------


def _one_rank_ops(mesh, name):
    import gmres_tpu_torch as tt
    from gmres_tpu_torch.parallel.halo import rdma_stencil_operator

    return {"poisson": lambda: tt.halo_poisson_operator(mesh),
            "cbpr2": lambda: tt.halo_chebyshev_preconditioner(mesh, 0.2, 8.2),
            "rdma": lambda: rdma_stencil_operator(mesh)}[name]()


@pytest.mark.parametrize("name", ["poisson", "cbpr2", "rdma"])
def test_vmapped_plain_rows_take_the_block_form(tmp_path, name):
    """torch.func.vmap of a halo-route operator over a plain block (the
    rank's own rows, as a plain tensor is the rank's block): one exchange
    for the block, each row bitwise the operator on that row."""
    from gmres_tpu_torch.parallel.halo import halo_exchange
    from tests.torch_parity import one_rank_mesh

    x = torch.as_tensor(seeded(970, (S, 16, 16)))
    with one_rank_mesh(str(tmp_path)) as mesh:
        op = _one_rank_ops(mesh, name)
        halo_exchange.exchanges = 0
        y = torch.func.vmap(op)(x)
        assert halo_exchange.exchanges == 1
        assert torch.equal(y, torch.stack([op(x[i]) for i in range(S)]))


def _rows_of(fn, xb, blk, mesh):
    """fn on the sharded block through row_apply, with the type of each
    argument fn is called with, the block's halo exchanges, its rows
    applied one by one as DTensors and their exchanges."""
    from torch.distributed.tensor import distribute_tensor

    from gmres_tpu_torch.ops.blas import row_apply, row_blocks
    from gmres_tpu_torch.parallel.halo import halo_exchange

    seen = []

    def counted(v):
        seen.append(type(v).__name__)
        return fn(v)

    halo_exchange.exchanges = 0
    y = row_apply(row_blocks(counted, fn), xb).full_tensor()
    block_exchanges = halo_exchange.exchanges
    halo_exchange.exchanges = 0
    rows = [fn(distribute_tensor(blk[i], mesh, [Shard(0)])).full_tensor()
            for i in range(S)]
    return y, seen, block_exchanges, rows, halo_exchange.exchanges


def test_operators_without_a_block_form_go_row_by_row(tmp_path):
    """On a sharded block, operators that are not marked as taking it whole
    (ops/blas.py:row_blocks) go one row at a time in row_apply, each call
    on the row's DTensor and none before the rows: the Nyström
    preconditioner built on a sharded x_like and the deflation
    preconditioner (their applications reduce over the mesh), M∘A
    (requests.composed) of the Nyström preconditioner and the halo
    operator, and an operator of the caller's own around the halo operator,
    whose exchanges are then s times one row's (none spent on the block).
    Each row is bitwise its own call. Batched by vmap, each of the first
    two raises NotImplementedError (no block form) before it communicates."""
    import gmres_tpu_torch as tt
    from gmres_tpu_torch.ops.blas import row_apply, takes_row_blocks
    from gmres_tpu_torch.parallel.halo import halo_exchange
    from gmres_tpu_torch.solvers.requests import composed
    from tests.torch_parity import one_rank_mesh

    n = 16
    x = torch.as_tensor(seeded(971, (S, n, n)))
    with one_rank_mesh(str(tmp_path)) as mesh:
        m_ny, _ = tt.nystrom_preconditioner(
            tt.poisson_operator(n), tt.shard_grid_vector(torch.zeros((n, n),
                                                                     dtype=torch.float64),
                                                         mesh), rank=4)
        m_defl = tt.coarse_space_preconditioner(
            tt.poisson_operator(n), tt.dirichlet_poisson_modes(n, 3, device="cpu"))
        halo = tt.halo_poisson_operator(mesh)
        m_a = composed(m_ny, halo)
        own = lambda v: 2.0 * halo(v)  # noqa: E731  (the caller's own operator)
        assert takes_row_blocks(halo)
        for fn, refuses in ((m_ny, True), (m_defl, True), (m_a, False), (own, False)):
            assert not takes_row_blocks(fn)
            xb = distribute_tensor(x, mesh, [Shard(1)])
            if refuses:
                halo_exchange.exchanges = 0
                with pytest.raises(NotImplementedError, match="no block form"):
                    torch.func.vmap(fn)(xb)
                assert halo_exchange.exchanges == 0
            seen = []

            def counted(v, fn=fn, seen=seen):
                seen.append(type(v).__name__)
                return fn(v)

            halo_exchange.exchanges = 0
            y = row_apply(counted, xb).full_tensor()
            block_exchanges = halo_exchange.exchanges
            assert seen == ["DTensor"] * S
            halo_exchange.exchanges = 0
            for i in range(S):
                row = distribute_tensor(x[i], mesh, [Shard(0)])
                assert torch.equal(y[i], fn(row).full_tensor())
            assert block_exchanges == halo_exchange.exchanges


def _scattered(n):
    """4·I with ten scattered off-diagonal entries: a HYB with an ELL
    residue."""
    a = 4.0 * np.eye(n)
    rng = np.random.default_rng(972)
    a[rng.integers(0, n, 10), rng.integers(0, n, 10)] += 1.0
    return a


@pytest.mark.parametrize("name", ["dia", "csr", "hyb_residue", "cycle", "mesh_cycle",
                                  "cycle_after_halo"])
def test_cycles_and_sparse_operators_take_the_block_form(tmp_path, name):
    """On a sharded block, a sparse operator (its rank rows), the mesh=None
    V-cycle on a DTensor, the mesh= cycle with a replicated level and M∘A
    (requests.composed) of the cycle and the halo operator are marked as
    taking the block whole: row_apply calls each once under vmap, with the
    block's exchanges those of one row's application, and each row bitwise
    its own call."""
    import gmres_tpu_torch as tt
    from gmres_tpu_torch.ops.blas import takes_row_blocks
    from gmres_tpu_torch.solvers.requests import composed
    from tests.torch_parity import one_rank_mesh

    n = 16
    x = torch.as_tensor(seeded(971, (S, n, n)))
    with one_rank_mesh(str(tmp_path)) as mesh:
        fn = {
            "dia": lambda: tt.sparse_operator(tt.poisson_dia(n, device="cpu")),
            "csr": lambda: tt.sparse_operator(tt.poisson_csr(n, device="cpu")),
            "hyb_residue": lambda: tt.sparse_operator(tt.csr_to_hyb(tt.csr_from_dense(
                _scattered(n * n), device="cpu"))),
            "cycle": lambda: tt.poisson_multigrid_preconditioner(n),
            "mesh_cycle": lambda: tt.poisson_multigrid_preconditioner(
                n, levels=2, mesh=mesh, replicate_below=n),
            "cycle_after_halo": lambda: composed(tt.poisson_multigrid_preconditioner(n),
                                                 tt.halo_poisson_operator(mesh)),
        }[name]()
        assert takes_row_blocks(fn)
        blk = x if "cycle" in name else x.reshape(S, -1)
        xb = distribute_tensor(blk, mesh, [Shard(1)])
        y, seen, block_exchanges, rows, row_exchanges = _rows_of(fn, xb, blk, mesh)
        assert len(seen) == 1 and seen != ["DTensor"]
        assert block_exchanges * S == row_exchanges
        for i in range(S):
            assert torch.equal(y[i], rows[i])
