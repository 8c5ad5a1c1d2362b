"""Batched GCRO-DR over an operator family swept over lanes
(``gmres_tpu_torch.batched_solve`` with gcrodr, convection–diffusion γ a
lane argument, the cycle shared) against gmres_tpu's ``jax.vmap`` of the
same solve on the same numpy inputs, and each lane against the port's own
sequential solve: the rules of tests/test_torch_batched_deflated.py (its
other cases), in a file of its own to keep each pytest-xdist file short.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu.models.convection_diffusion import convection_diffusion_apply as cd_j
from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_apply as cd_t
from tests.test_torch_batched_deflated import LANES, _check_lanes
from tests.torch_parity import rel_err, to_torch


def test_gcrodr_over_gamma_lanes_with_the_cycle():
    """GCRO-DR(12, k 4) with the convdiff cycle (built at γ 0.4, shared),
    convdiff 24², γ a lane argument (tests/test_torch_gcrodr.py's exact
    case "mg"); each lane's recycle block its sequential solve's."""
    n, kw = 24, {"k": 4, "restart": 12, "tol": 1e-10}
    gammas = np.array([0.3, 0.4, 0.5])
    bs = np.stack([np.asarray(cd_j(jnp.ones((n, n)), g, 0.2)) for g in gammas])
    m = tt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
    gt_ = to_torch(gammas)
    res = tt.batched_solve(tt.gcrodr, lambda v, g: cd_t(v, g, 0.2), to_torch(bs),
                           lane_args=(gt_,), M=m, **kw)
    singles = [tt.gcrodr(lambda v, g=gt_[k]: cd_t(v, g, 0.2), to_torch(bs[k]), M=m, **kw)
               for k in range(LANES)]
    _check_lanes(res, singles, ("restarts", "iterations", "status"))
    for k in range(LANES):
        assert torch.equal(res.recycle[k], singles[k].recycle), k
    mj = gt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
    rj = jax.vmap(lambda b, g: gt.gcrodr(lambda v: cd_j(v, g, 0.2), b, M=mj, **kw))(
        jnp.asarray(bs), jnp.asarray(gammas))
    for k in range(LANES):
        assert int(res.status[k]) == int(rj.status[k]) == 0, k
        assert (int(res.restarts[k]), int(res.iterations[k])) == \
            (int(rj.restarts[k]), int(rj.iterations[k])), k
        assert rel_err(res.x[k], rj.x[k]) <= 1e-9, k
