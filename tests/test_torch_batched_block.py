"""Batched block solves (``gmres_tpu_torch.batched_solve`` with block_cg
and block_gmres, each lane a block of s right-hand sides) against
gmres_tpu's ``jax.vmap`` of the same solve on the same seeded numpy inputs,
and each lane against the port's own sequential solve.

A block application of every lane is one nested ``torch.func.vmap`` (the
lanes, then each lane's rows): one block call of each kernel route on the
path for all lanes' rows (``ops/_cuda.py:through_lanes``, one launch a
kernel on the card). Against the port's sequential solve: the counts,
status, x and the certified residuals bitwise, and the batch's host reads
those of its longest lane. Against JAX's vmapped lane, the bands of
tests/test_torch_block_cg.py and tests/test_torch_block_idrs.py: the
counts and status equal, x within 1e-9 of JAX's relative to max|x|, the
residuals within 1e-6 relative or 1e-12 absolute.
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
from gmres_tpu_torch.ops import fused as tfu
from gmres_tpu_torch.ops import stencil as tst
from tests.torch_parity import rel_err, seeded, to_np, to_torch

LANES, S = 3, 2
COUNTERS = (tst.stencil_5pt_pallas, tst.residual_restrict, tst.correct_residual,
            tfu.poly_stencil_smoother_pallas)


def _block_calls():
    return [c.block_calls for c in COUNTERS]


def _rhs(n, seed):
    xs = seeded(seed, (LANES, S, n, n))
    return np.asarray(jax.vmap(jax.vmap(gt.poisson_operator(n)))(jnp.asarray(xs)))


def _check(res, singles, count):
    for k, single in enumerate(singles):
        assert int(getattr(res, count)[k]) == getattr(single, count), k
        assert int(res.status[k]) == single.status, k
        assert torch.equal(res.x[k], single.x), k
        assert torch.equal(res.residuals[k], single.residuals), k
    assert res.host_syncs == max(s.host_syncs for s in singles)


def _against_jax(res, rj, count):
    for k in range(LANES):
        assert (int(getattr(res, count)[k]), int(res.status[k])) == \
            (int(getattr(rj, count)[k]), int(rj.status[k])), k
        assert rel_err(res.x[k], rj.x[k]) <= 1e-9, k
        np.testing.assert_allclose(to_np(res.residuals[k]), np.asarray(rj.residuals[k]),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name", ["block_cg", "block_gmres"])
def test_lanes_of_blocks_with_the_cycle(name):
    """Poisson 16² with its V-cycle, three lanes of two right-hand sides:
    one block call of K1's route and of each V-cycle form a block
    application of all lanes."""
    n = 16
    bs = _rhs(n, 600)
    kw = {"tol": 1e-9} if name == "block_cg" else {"restart": 10, "tol": 1e-10}
    count = "iterations" if name == "block_cg" else "restarts"
    op, m = tt.poisson_operator(n), tt.poisson_multigrid_preconditioner(n)
    solver = getattr(tt, name)
    before = _block_calls()
    res = tt.batched_solve(solver, op, to_torch(bs), M=m, **kw)
    calls = [a - b for a, b in zip(_block_calls(), before)]
    singles = [solver(op, to_torch(b), M=m, **kw) for b in bs]
    _check(res, singles, count)
    # Block calls, never one a lane or a row: K1's route at least once a
    # block iteration (block CG: exactly once, plus the certification), the
    # V-cycle's smoother (K2's route) and its fused forms alike.
    longest = max(getattr(s, count) for s in singles)
    if name == "block_cg":
        assert calls[0] == longest + 1
    assert calls[0] >= longest and calls[3] >= 1 and calls[1] == calls[2]
    opj, mj = gt.poisson_operator(n), gt.poisson_multigrid_preconditioner(n)
    jsolver = getattr(gt, name)
    rj = jax.vmap(lambda b: jsolver(opj, b, M=mj, **kw))(jnp.asarray(bs))
    _against_jax(res, rj, count)


def test_block_gmres_over_gamma_lanes():
    """block_gmres on convdiff 12², γ a lane argument (each lane's block
    one operator of the family): the lanes' per-lane coefficients repeated
    down each lane's rows in one block call."""
    n, kw = 12, {"restart": 6, "tol": 1e-9}
    gammas = np.array([0.2, 0.4, 0.6])
    xs = seeded(612, (LANES, S, n, n))
    bs = np.stack([np.asarray(jax.vmap(lambda v, g=g: cd_j(v, g, 0.2))(jnp.asarray(xs[k])))
                   for k, g in enumerate(gammas)])
    g_t = to_torch(gammas)
    calls = tst.stencil_5pt_pallas.block_calls
    res = tt.batched_solve(tt.block_gmres, lambda v, g: cd_t(v, g, 0.2), to_torch(bs),
                           lane_args=(g_t,), **kw)
    assert tst.stencil_5pt_pallas.block_calls > calls
    singles = [tt.block_gmres(lambda v, g=g_t[k]: cd_t(v, g, 0.2), to_torch(bs[k]), **kw)
               for k in range(LANES)]
    _check(res, singles, "restarts")
    rj = jax.vmap(lambda b, g: gt.block_gmres(lambda v: cd_j(v, g, 0.2), b, **kw))(
        jnp.asarray(bs), jnp.asarray(gammas))
    _against_jax(res, rj, "restarts")
