"""Batched solves of the deflated and recycling GMRES solvers
(``gmres_tpu_torch.batched_solve`` with gmres_dr and gcrodr; gcrodr over γ
lanes is tests/test_torch_batched_gcrodr.py, newton_krylov's gcrodr inner
tests/test_torch_batched_newton_gcrodr.py) against gmres_tpu's
``jax.vmap`` of the same solve on the same seeded numpy inputs, and each
lane against the port's own sequential solve.

Against the port's sequential solve: restarts, iterations, status, the
residual history, x (and GCRO-DR's recycle block) bitwise: each lane's
cycle state comes back in the batch's one read a cycle and its eigensolve
runs on its own float64 copy. Against JAX's vmapped lane, the bands of the
sequential parity tests (tests/test_torch_deflated.py,
tests/test_torch_gcrodr.py: on these exact cases the counts equal and x
within 1e-9 of JAX's relative to max|x|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu_torch.ops import stencil as tst
from tests.torch_parity import rel_err, seeded, to_torch

LANES = 3


def _check_lanes(res, singles, fields):
    for k, single in enumerate(singles):
        for name in fields:
            assert int(getattr(res, name)[k]) == int(getattr(single, name)), (name, k)
        assert torch.equal(res.residual_history[k], single.residual_history), k
        assert torch.equal(res.x[k], single.x), k
    assert res.host_syncs == max(s.host_syncs for s in singles)


def test_gmres_dr_over_seeded_right_hand_sides():
    """GMRES-DR(16, 4) with the cbpr2 polynomial, Poisson 24²
    (tests/test_torch_deflated.py's exact case "poisson-cbpr2-k4")."""
    n, kw = 24, {"restart": 16, "deflate": 4, "tol": 1e-10}
    bs = np.stack([np.asarray(gt.poisson_operator(n)(jnp.asarray(seeded(500 + k, (n, n)))))
                   for k in range(LANES)])
    op = tt.poisson_operator(n)
    m = tt.chebyshev_preconditioner(op, 0.2, 8.2)
    res = tt.batched_solve(tt.gmres_dr, op, to_torch(bs), M=m, **kw)
    singles = [tt.gmres_dr(op, to_torch(b), M=m, **kw) for b in bs]
    _check_lanes(res, singles, ("restarts", "iterations", "status"))
    opj = gt.poisson_operator(n)
    mj = gt.chebyshev_preconditioner(opj, 0.2, 8.2)
    rj = jax.vmap(lambda b: gt.gmres_dr(opj, b, M=mj, **kw))(jnp.asarray(bs))
    for k in range(LANES):
        assert int(res.status[k]) == int(rj.status[k]) == 0, k
        assert (int(res.restarts[k]), int(res.iterations[k])) == \
            (int(rj.restarts[k]), int(rj.iterations[k])), k
        assert rel_err(res.x[k], rj.x[k]) <= 1e-9, k


def test_gcrodr_recycle_block_per_lane():
    """A recycle block a lane (recycle= with the lanes first): the import is
    one block application for every lane (a nested vmap: one block call of
    K1's route), and each lane is its sequential solve with its own block."""
    n, kw = 16, {"k": 3, "restart": 10, "tol": 1e-10}
    op = tt.convection_diffusion_operator(n, 0.4, 0.2)
    bs = to_torch(seeded(520, (LANES, n, n)))
    first = tt.batched_solve(tt.gcrodr, op, bs, **kw)
    # Each lane's steps with its own block (what jax.vmap makes of a
    # vmapped recycle= argument).
    from gmres_tpu_torch.solvers.gcrodr import gcrodr_steps
    from gmres_tpu_torch.solvers.requests import LaneOperator, run_lanes

    a_lanes = LaneOperator(op)
    calls = tst.stencil_5pt_pallas.block_calls
    results, _ = run_lanes([gcrodr_steps(a_lanes, bs[k] * 0.5, recycle=first.recycle[k],
                                         **kw) for k in range(LANES)])
    assert tst.stencil_5pt_pallas.block_calls > calls
    for k in range(LANES):
        single = tt.gcrodr(op, bs[k] * 0.5, recycle=first.recycle[k], **kw)
        assert (results[k].restarts, results[k].iterations) == \
            (single.restarts, single.iterations), k
        assert torch.equal(results[k].x, single.x), k
        assert torch.equal(results[k].recycle, single.recycle), k
