"""Batched solves of the solvers that apply a transpose
(``gmres_tpu_torch.batched_solve`` with qmr, lsqr and lsmr) over an
operator family swept over lanes (convection–diffusion, γ a lane argument),
against gmres_tpu's ``jax.vmap`` of the same solve on the same seeded numpy
inputs, and each lane against the port's own sequential solve.

Against the port's sequential solve: iterations, status, residual history
and x bitwise (the lanes' transposes of one operator are one pullback of
the vmapped operator, ``solvers/requests.py:LaneTranspose``), and the
batch's host reads those of its longest lane. Against JAX's vmapped lane:
the same status, the iterations within the band the sequential parity
test pins (tests/test_torch_transpose_solvers.py: QMR within QMR_SPREAD,
LSQR and LSMR equal to gmres_tpu's sequential solve on the convdiff
stencil, and within 1 of its vmapped lane), and x within that file's
tolerance (QMR 1e-7 of the true solution, LSQR and LSMR 1e-9 of JAX's x).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu.models.convection_diffusion import convection_diffusion_apply as cd_j
from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_apply as cd_t
from gmres_tpu_torch.ops import stencil as tst
from tests.test_torch_transpose_solvers import QMR_SPREAD
from tests.torch_parity import seeded, to_np, to_torch

GAMMAS = np.array([0.3, 0.4, 0.5])


def _a_t(v, g):
    return cd_t(v, g, 0.2)


def _check_lanes(res, singles):
    for k, single in enumerate(singles):
        assert int(res.iterations[k]) == single.iterations, k
        assert int(res.status[k]) == single.status, k
        assert torch.equal(res.residual_history[k], single.residual_history), k
        assert torch.equal(res.x[k], single.x), k
    assert res.host_syncs == max(s.host_syncs for s in singles)


def _rhs(n, seed):
    """Each lane's b = A(γ) x_true, from one seeded x_true a lane."""
    xs = seeded(seed, (len(GAMMAS), n, n))
    bs = np.stack([np.asarray(cd_j(jnp.asarray(xs[k]), GAMMAS[k], 0.2))
                   for k in range(len(GAMMAS))])
    return xs, bs


@pytest.mark.parametrize("name", ["qmr", "lsqr", "lsmr"])
def test_gamma_lanes_match_sequential_and_jax_vmap(name):
    n = 12 if name == "qmr" else 16
    kw = {"tol": 1e-10, "max_iterations": 2000}
    xs, bs = _rhs(n, 400 + n)
    gammas = to_torch(GAMMAS)
    solver = getattr(tt, name)
    calls = tst.stencil_5pt_pallas.block_calls
    res = tt.batched_solve(solver, _a_t, to_torch(bs), lane_args=(gammas,), **kw)
    assert tst.stencil_5pt_pallas.block_calls > calls
    singles = [solver(lambda v, g=gammas[k]: _a_t(v, g), to_torch(bs[k]), **kw)
               for k in range(len(GAMMAS))]
    _check_lanes(res, singles)
    jsolver = getattr(gt, name)
    rj = jax.vmap(lambda b, g: jsolver(lambda v: cd_j(v, g, 0.2), b, **kw))(
        jnp.asarray(bs), jnp.asarray(GAMMAS))
    for k in range(len(GAMMAS)):
        assert int(res.status[k]) == int(rj.status[k]) == 0, k
        its, jits = int(res.iterations[k]), int(rj.iterations[k])
        if name == "qmr":
            assert abs(its - jits) <= max(2, QMR_SPREAD * jits), k
            np.testing.assert_allclose(to_np(res.x[k]), xs[k], atol=1e-7)
        else:
            # gmres_tpu's own vmapped lane may take one step more than its
            # sequential solve (LSMR at γ 0.3: 238 against 237, its batched
            # reductions round differently near the 1e-10 crossing); the
            # port's lane takes the sequential solve's count.
            rs = jsolver(lambda v: cd_j(v, GAMMAS[k], 0.2), jnp.asarray(bs[k]), **kw)
            assert its == int(rs.iterations) and abs(its - jits) <= 1, k
            np.testing.assert_allclose(to_np(res.x[k]), np.asarray(rj.x[k]), atol=1e-9)


def test_qmr_with_the_cycle_and_mt_over_gamma_lanes():
    """M the convdiff cycle (one for every lane, built at γ = 0.4), MT its
    transpose=True cycle, both single-lane callables vmapped as M is:
    (M∘A)ᵀ = Aᵀ∘Mᵀ with the lanes' Aᵀ one pullback. Against gmres_tpu's
    jax.vmap of the same solve: counts within QMR_SPREAD, x within 1e-7."""
    n = 16
    xs, bs = _rhs(n, 416)
    gammas = to_torch(GAMMAS)
    kw = {"tol": 1e-9}
    m = tt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
    mt = tt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2, transpose=True)
    res = tt.batched_solve(tt.qmr, _a_t, to_torch(bs), lane_args=(gammas,), M=m, MT=mt,
                           **kw)
    singles = [tt.qmr(lambda v, g=gammas[k]: _a_t(v, g), to_torch(bs[k]), M=m, MT=mt,
                      **kw) for k in range(len(GAMMAS))]
    _check_lanes(res, singles)
    mj = gt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
    mtj = gt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2, transpose=True)
    rj = jax.vmap(lambda b, g: gt.qmr(lambda v: cd_j(v, g, 0.2), b, M=mj, MT=mtj, **kw))(
        jnp.asarray(bs), jnp.asarray(GAMMAS))
    for k in range(len(GAMMAS)):
        assert int(res.status[k]) == int(rj.status[k]) == 0, k
        its, jits = int(res.iterations[k]), int(rj.iterations[k])
        assert abs(its - jits) <= max(2, QMR_SPREAD * jits), k
        np.testing.assert_allclose(to_np(res.x[k]), xs[k], atol=1e-7)


def test_caller_transposes_are_lane_operators():
    """AT= (QMR) and AH= (LSQR) given by the caller: single-lane callables,
    vmapped as M is; each lane bitwise its sequential solve."""
    n = 12
    _, bs = _rhs(n, 412)
    op = tt.convection_diffusion_operator(n, 0.4, 0.2)
    op_t = tt.convection_diffusion_operator(n, -0.4, -0.2)
    for solver, key in ((tt.qmr, "AT"), (tt.lsqr, "AH")):
        kw = {"tol": 1e-10, key: op_t}
        res = tt.batched_solve(solver, op, to_torch(bs), **kw)
        _check_lanes(res, [solver(op, to_torch(b), **kw) for b in bs])
