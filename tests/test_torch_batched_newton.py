"""Batched solves of the GMRES family and Newton–Krylov
(``gmres_tpu_torch.batched_solve`` with fgmres, lgmres, sstep_gmres and
newton_krylov), SLQ's batched probes, and the sparse operators under
``torch.func.vmap``, against gmres_tpu's ``jax.vmap`` on the same numpy
inputs and against the port's own sequential runs.

Against the port's sequential solve: iterations, restarts, status,
residual history and x bitwise. Against JAX's vmapped lane
(test_torch_gmres_family.py's tolerances): restarts and final-cycle
iterations equal, the same status, x within 1e-9 of JAX's relative to
max|x| (s-step GMRES's Gram solve squares the monomial basis's condition:
x within 1e-6 there, the counts equal). Newton–Krylov: the mirror of
tests/test_batched.py::test_vmap_newton_continuation (24², λ 1, 3, 5,
6.5, restart 20, no M): every lane converged, ‖u‖ maxima rising, lane 3
within 1e-9 of its single solve; Newton steps JAX's vmapped lanes' and x
within 1e-9 of them (test_torch_newton_implicit.py's float64 parity); the
inner iterations within 1 of JAX's (λ = 6.5, 5% below the fold, takes 241
in the port, sequential as batched, and 242 in gmres_tpu, eager as
vmapped: the nearly singular Jacobian moves one tol-boundary crossing of
an inner GMRES with the last bits of J·v, which the port recomputes by
``torch.func.jvp`` where gmres_tpu linearises once; tests/test_batched.py
allows the same ±1 between its batched and single lanes); the same sweep
with the frozen Poisson V-cycle as M (the FGMRES inner).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
from gmres_tpu.ops import sparse as jsp
import gmres_tpu_torch as tt
from gmres_tpu_torch.ops import sparse as tsp
from gmres_tpu_torch.ops.blas import tree_vdot
from gmres_tpu_torch.ops import stencil as tst
from gmres_tpu_torch.solvers import funm as tfunm
from tests.torch_parity import np_poisson, rel_err, seeded, to_torch

LANES = 3
# label: (solver, problem (model, n, preconditioner), keywords, x tolerance).
CASES = {
    "fgmres-cbpr2": ("fgmres", ("poisson", 16, "cbpr2"), {"restart": 10, "tol": 1e-10}, 1e-9),
    "fgmres-mg": ("fgmres", ("convdiff", 24, "mg"), {"restart": 10, "tol": 1e-10}, 1e-9),
    "lgmres": ("lgmres", ("convdiff", 16, None), {"restart": 8, "aug": 3, "tol": 1e-9}, 1e-9),
    "lgmres-cbpr2": ("lgmres", ("poisson", 16, "cbpr2"),
                     {"restart": 5, "aug": 2, "tol": 1e-10}, 1e-9),
    "sstep_gmres": ("sstep_gmres", ("poisson", 12, None), {"s": 3, "tol": 1e-8}, 1e-6),
    "sstep_gmres-cheb16": ("sstep_gmres", ("poisson", 16, "cheb16"), {"s": 6, "tol": 1e-9},
                           1e-6),
}


def _problem(pkg, spec):
    model, n, precond = spec
    op = (pkg.poisson_operator(n) if model == "poisson"
          else pkg.convection_diffusion_operator(n, 0.4, 0.2))
    m = None
    if precond == "cbpr2":
        m = pkg.chebyshev_preconditioner(op, 0.2, 8.2)
    elif precond == "cheb16":
        m = pkg.chebyshev_preconditioner(op, 0.005, 8.0, order=16)
    elif precond == "mg":
        m = pkg.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
    return op, m


def _check_lanes(res, singles, fields):
    for k, single in enumerate(singles):
        for name in fields:
            assert int(getattr(res, name)[k]) == int(getattr(single, name)), (name, k)
        assert torch.equal(res.residual_history[k], single.residual_history), k
        assert torch.equal(res.x[k], single.x), k


@pytest.mark.parametrize("label", list(CASES))
def test_family_batched_matches_sequential_and_jax_vmap(label):
    name, spec, kw, x_tol = CASES[label]
    n = spec[1]
    bs = seeded(400 + n, (LANES, n, n))
    opj, mj = _problem(gt, spec)
    rj = jax.vmap(lambda b: getattr(gt, name)(opj, b, M=mj, **kw))(jnp.asarray(bs))
    opt, mt = _problem(tt, spec)
    solver = getattr(tt, name)
    res = tt.batched_solve(solver, opt, to_torch(bs), M=mt, **kw)
    singles = [solver(opt, to_torch(bs[k]), M=mt, **kw) for k in range(LANES)]
    fields = ("iterations", "restarts", "status")
    _check_lanes(res, singles, fields)
    assert res.host_syncs == max(s.host_syncs for s in singles)
    for k in range(LANES):
        for f in fields:
            assert int(getattr(res, f)[k]) == int(getattr(rj, f)[k]), (f, k)
        assert int(res.status[k]) == 0
        assert rel_err(res.x[k], np.asarray(rj.x[k])) <= x_tol, k


N_BRATU = 24
LAMS = (1.0, 3.0, 5.0, 6.5)


def _bratu_jax(precond):
    """tests/test_batched.py::test_vmap_newton_continuation's sweep (with
    the Poisson V-cycle as M where asked), its jit(vmap) run."""
    from gmres_tpu.models.poisson import poisson_apply

    n = N_BRATU
    h2 = (1.0 / (n + 1)) ** 2
    m = gt.poisson_multigrid_preconditioner(n) if precond else None

    def solve(lam):
        F = lambda u: poisson_apply(u) - (lam * h2) * jnp.exp(u)  # noqa: E731
        return gt.newton_krylov(F, jnp.zeros((n, n)), tol=1e-10, restart=20, M=m)

    return jax.jit(jax.vmap(solve))(jnp.asarray(LAMS))


@pytest.mark.parametrize("precond", [False, True])
def test_vmap_newton_continuation(precond):
    """The Bratu λ-sweep as one batched JFNK solve: F(u, λ) with λ split per
    lane, J·v at each lane's own linearisation point one vmapped jvp for
    the lanes."""
    from gmres_tpu_torch.models.poisson import poisson_apply

    n = N_BRATU
    h2 = (1.0 / (n + 1)) ** 2
    lams = torch.tensor(LAMS, dtype=torch.float64)

    def F(u, lam):
        return poisson_apply(u) - (lam * h2) * torch.exp(u)

    m = tt.poisson_multigrid_preconditioner(n) if precond else None
    kw = dict(tol=1e-10, restart=20, M=m)
    calls = tst.stencil_5pt_pallas.block_calls
    res = tt.batched_solve(tt.newton_krylov, F, torch.zeros((4, n, n), dtype=torch.float64),
                           lane_args=(lams,), **kw)
    assert tst.stencil_5pt_pallas.block_calls > calls
    assert bool(torch.all(res.status == tt.SolverStatus.CONVERGED))
    umax = res.x.amax(dim=(1, 2)).numpy()
    assert np.all(np.diff(umax) > 0)
    singles = [tt.newton_krylov(lambda u, lam=lam: F(u, lam), torch.zeros((n, n),
                                dtype=torch.float64), **kw) for lam in lams]
    _check_lanes(res, singles, ("iterations", "status", "inner_iterations", "jv_products"))
    np.testing.assert_allclose(res.x[3].numpy(), singles[3].x.numpy(), atol=1e-9)
    assert res.host_syncs == max(s.host_syncs for s in singles)
    rj = _bratu_jax(precond)
    for k in range(len(LAMS)):
        assert int(res.iterations[k]) == int(rj.iterations[k]), k
        assert abs(int(res.inner_iterations[k]) - int(rj.inner_iterations[k])) <= 1, k
        np.testing.assert_allclose(res.x[k].numpy(), np.asarray(rj.x[k]), atol=1e-9)


def test_newton_jvp_rule_under_vmap():
    """J·v through K1's autograd.Function (the card's route: Stencil5Grid,
    here on its plain version) under torch.func.vmap: its jvp rule runs
    once for the lanes of each batched J·v, on their block, and the lanes
    are bitwise their sequential solves."""
    n = 16
    h2 = (1.0 / (n + 1)) ** 2
    lams = torch.tensor([2.0, 5.0], dtype=torch.float64)

    def F(u, lam):
        return tst.stencil5_grid(u) - (lam * h2) * torch.exp(u)

    rules = tst.Stencil5Grid.rule_applications["tangent"]
    calls = tst.stencil_5pt_pallas.block_calls
    x0s = torch.zeros((2, n, n), dtype=torch.float64)
    res = tt.batched_solve(tt.newton_krylov, F, x0s, lane_args=(lams,), tol=1e-10,
                           restart=20)
    tangents = tst.Stencil5Grid.rule_applications["tangent"] - rules
    singles = [tt.newton_krylov(lambda u, lam=lam: F(u, lam), x0s[0], tol=1e-10, restart=20)
               for lam in lams]
    _check_lanes(res, singles, ("iterations", "status", "jv_products"))
    # One tangent a batched J·v (a lane running alone takes its own), each
    # J·v of both lanes one block call for the primal and one for the
    # tangent.
    jv = [s.jv_products for s in singles]
    assert max(jv) <= tangents < sum(jv)
    assert tst.stencil_5pt_pallas.block_calls - calls >= 2 * (sum(jv) - tangents)


def test_newton_gcrodr_inner_and_other_solvers_raise():
    """The gcrodr inner batches now (its lanes are
    tests/test_torch_batched_deflated.py's); the solvers whose loop takes
    host numpy steps, which gmres_tpu's jax.vmap cannot trace either, still
    raise."""
    op = tt.poisson_operator(8)
    bs = torch.zeros((2, 8, 8), dtype=torch.float64)
    res = tt.batched_solve(tt.newton_krylov, lambda u: op(u) - 1.0, bs, inner="gcrodr",
                           recycle_k=2, restart=8)
    assert res.status.tolist() == [0, 0]
    for solver in (tt.arnoldi_eigs_real, tt.subspace_eigs):
        with pytest.raises(NotImplementedError, match="jax.vmap cannot trace"):
            tt.batched_solve(solver, op, bs)


def test_trace_funm_batches_its_probes():
    """SLQ's probes as lanes: one application of A an Arnoldi step for all
    probes (one block call of K1's route), one read of the Hessenbergs,
    and the samples bitwise the loop's (one factorization a probe)."""
    n, probes, steps = 16, 6, 12
    op = tt.poisson_operator(n)
    x_like = torch.zeros((n, n), dtype=torch.float64)
    calls = tst.stencil_5pt_pallas.block_calls
    res = tt.trace_funm(op, torch.log, x_like, n_probes=probes, steps=steps, key=3)
    assert tst.stencil_5pt_pallas.block_calls - calls == steps
    assert res.host_syncs == 1
    z = tfunm._rademacher(probes, (n, n), torch.float64, "cpu", 3)
    loop = []
    for i in range(probes):
        _, hmat = tt.solvers.lanczos.arnoldi_factorization(op, z[i], steps)
        theta, q, _, _ = tfunm._projected_eigh(hmat, steps)
        loop.append(tree_vdot(z[i], z[i]) * torch.sum(torch.log(theta) * q[0, :] ** 2))
    assert torch.equal(res.samples, torch.stack(loop))


def _poisson_dense(n):
    return np.stack([np_poisson(e.reshape(n, n)).reshape(-1) for e in np.eye(n * n)], axis=1)


@pytest.mark.parametrize("lanes", [4, 9, 17])
@pytest.mark.parametrize("fmt", ["dia", "hyb", "bsr"])
def test_sparse_operators_under_vmap_bitwise(fmt, lanes):
    """torch.func.vmap of the DIA, HYB and BSR operators: one call of the
    routed entry on the lanes' block (K3's or K4's batched launch on the
    card), each lane bitwise its own application, at lane counts on either
    side of a chunk (9: past K3's 8 and K4's 8; 17: past K3's 16); and each
    lane within 1e-14 of max|y| of gmres_tpu's jax.vmap of the same
    operator through its Pallas kernel in interpret mode (BSR's kernel is
    float32: within 1e-6)."""
    n = 12
    dense = _poisson_dense(n)
    mats = {"dia": lambda: tt.poisson_dia(n, device="cpu"),
            "hyb": lambda: tt.csr_to_hyb(tt.poisson_csr(n, device="cpu")),
            "bsr": lambda: tsp.bsr_from_dense(dense, 4, device="cpu")}
    op = tt.sparse_operator(mats[fmt]())
    rows = to_torch(seeded(96, (lanes, n * n)))
    entry = tsp.bsr_spmv_pallas if fmt == "bsr" else tsp.dia_spmv_pallas
    before = entry.block_calls
    out = torch.func.vmap(op)(rows)
    assert entry.block_calls == before + 1
    for k in range(rows.shape[0]):
        assert torch.equal(out[k], op(rows[k]))
    grids = rows.reshape(lanes, n, n)
    assert torch.equal(torch.func.vmap(op)(grids), out)
    if fmt == "dia":
        mj = jsp.poisson_dia(n)
        jfn = jax.vmap(lambda v: jsp.dia_spmv_pallas(mj, v, interpret=True))
    elif fmt == "hyb":
        mj = jsp.csr_to_hyb(jsp.poisson_csr(n))
        jfn = jax.vmap(lambda v: jsp.hyb_spmv(mj, v, use_pallas=True, interpret=True))
    else:
        mj = jsp.bsr_from_dense(dense.astype(np.float32), 4)
        jfn = jax.vmap(lambda v: jsp.bsr_spmv_pallas(mj, v, interpret=True))
    jdt, tol = (jnp.float32, 1e-6) if fmt == "bsr" else (jnp.float64, 1e-14)
    yj = np.asarray(jfn(jnp.asarray(rows.numpy(), dtype=jdt)))
    for k in range(lanes):
        assert rel_err(out[k], yj[k]) < tol, k


def test_batched_cg_on_a_sparse_operator():
    """CG on the HYB Poisson operator, three lanes: each lane bitwise its
    sequential solve, every application of A one block call of K3's route
    while more than one lane runs (the longest lane's applications, less
    those it makes alone)."""
    n = 12
    op = tt.sparse_operator(tt.csr_to_hyb(tt.poisson_csr(n, device="cpu")))
    bs = to_torch(seeded(97, (3, n * n)))
    before = tsp.dia_spmv_pallas.block_calls
    res = tt.batched_solve(tt.cg, op, bs, tol=1e-10)
    singles = [tt.cg(op, bs[k], tol=1e-10) for k in range(3)]
    _check_lanes(res, singles, ("iterations", "status"))
    its = sorted(s.iterations for s in singles)
    assert tsp.dia_spmv_pallas.block_calls - before == its[-2] + 1
