"""The multigrid V-cycle of the PyTorch port against gmres_tpu: intergrid
transfers, the cycle's output, its static plan and its accounting."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gmres_tpu as gt
from gmres_tpu.ops.fused import chebyshev_k_scalars
from gmres_tpu.precond import multigrid as jmg
import gmres_tpu_torch as tt
from gmres_tpu_torch.ops.fused import poly_stencil_smoother_plain
from tests.torch_parity import one_rank_mesh, rel_err, seeded, to_np, to_torch


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_transfers_match(dtype):
    x = seeded(700, (12, 12), dtype)
    np.testing.assert_array_equal(to_np(tt.restrict_sum(to_torch(x))),
                                  to_np(jmg.restrict_sum(jnp.asarray(x))))
    np.testing.assert_array_equal(to_np(tt.prolong_repeat(to_torch(x))),
                                  to_np(jmg.prolong_repeat(jnp.asarray(x))))


@pytest.mark.parametrize("n", [32, 64, 96])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_v_cycle_matches(n, dtype):
    mj = gt.poisson_multigrid_preconditioner(n)
    mt = tt.poisson_multigrid_preconditioner(n)
    assert mt.levels == mj.levels
    assert mt.fine_equiv_sweeps == mj.fine_equiv_sweeps
    r = seeded(701 + n, (n, n), dtype)
    z = mt(to_torch(r))
    assert z.dtype == to_torch(r).dtype and tuple(z.shape) == (n, n)
    # Same elementwise arithmetic; XLA may fuse a multiply-add where PyTorch
    # rounds twice, and the order-32 coarse solve amplifies such last-bit
    # differences.
    assert rel_err(z, mj(jnp.asarray(r))) < (1e-5 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("n,levels", [(300, 3), (2048, 8), (96, 4), (64, None)])
def test_plan_matches_jax(n, levels):
    """The plan is what the JAX code computes: the level rule
    (multigrid.py:94-99), the smoothers' and the coarse solve's (θ, steps)
    (fused.py:326-339, the same recurrence as chebyshev.py:68-76) and the
    coarse λ_min (multigrid.py:130-132)."""
    mt = tt.poisson_multigrid_preconditioner(n, levels=levels)
    mj = gt.poisson_multigrid_preconditioner(n, levels=levels)
    plan = mt.plan
    assert mt.levels == mj.levels == len(plan.sizes)
    assert plan.sizes == tuple(n // 2 ** l for l in range(mj.levels))
    assert mt.fine_equiv_sweeps == mj.fine_equiv_sweeps
    theta, _, steps = chebyshev_k_scalars(2.0, 8.0, 3)
    assert plan.pre_smooth == plan.post_smooth == (theta, tuple(steps))
    lam_min = 8.0 * math.sin(math.pi / (2 * (plan.sizes[-1] + 1))) ** 2
    assert plan.lam_min_coarse == lam_min
    theta, _, steps = chebyshev_k_scalars(lam_min, 8.0, 32)
    assert plan.coarse == (theta, tuple(steps))


def test_coarse_plan_applies_jax_recurrence():
    """The coarse plan's (θ, steps), run through the plain K2 recurrence,
    reproduce JAX's order-32 chebyshev_preconditioner recurrence."""
    mt = tt.poisson_multigrid_preconditioner(64)
    nc = mt.plan.sizes[-1]
    r = seeded(702, (nc, nc))
    ref = gt.chebyshev_preconditioner(gt.poisson_operator(nc),
                                      mt.plan.lam_min_coarse, 8.0, order=32,
                                      reference_form=False)(jnp.asarray(r))
    z = poly_stencil_smoother_plain(to_torch(r), *mt.plan.coarse)
    assert rel_err(z, ref) < 1e-12


def test_options_match_and_distributed_raises(tmp_path):
    """The options against JAX; the distributed options, which the port
    refused until the distributed slice: ``replicate_below`` without a mesh
    is ignored (JAX's rule), and the mesh= cycle on a one-rank mesh is the
    plain cycle within 1e-13 (its 8-row level replicated, one all-gather;
    tests/test_torch_dist.py runs 2 and 4 ranks)."""
    for kw in ({"pre_smooth": 2, "post_smooth": 4, "coarse_order": 16},
               {"pre_smooth": 0, "post_smooth": 1, "levels": 2}):
        mj = gt.poisson_multigrid_preconditioner(32, **kw)
        mt = tt.poisson_multigrid_preconditioner(32, **kw)
        assert mt.fine_equiv_sweeps == mj.fine_equiv_sweeps
        r = seeded(703, (32, 32))
        assert rel_err(mt(to_torch(r)), mj(jnp.asarray(r))) < 1e-12
    with pytest.raises(ValueError):
        tt.poisson_multigrid_preconditioner(30, levels=3)
    r = to_torch(seeded(704, (64, 64)))
    plain = tt.poisson_multigrid_preconditioner(64, levels=4)
    torch.testing.assert_close(
        tt.poisson_multigrid_preconditioner(64, levels=4, replicate_below=8)(r),
        plain(r), rtol=0, atol=0)
    with one_rank_mesh(tmp_path) as mesh:
        dm = tt.poisson_multigrid_preconditioner(64, levels=4, mesh=mesh,
                                                 replicate_below=16)
        assert dm.replicate_from == 3 and dm.levels == 4
        z = dm(tt.shard_grid_vector(r, mesh))
        assert rel_err(z.full_tensor(), plain(r)) <= 1e-13


def test_poisson_model_matches():
    n = 12
    x = seeded(704, (n, n))
    assert rel_err(tt.poisson_apply(to_torch(x)), gt.poisson_apply(jnp.asarray(x))) < 1e-15
    assert rel_err(tt.poisson_apply(to_torch(x.reshape(-1))),
                   gt.poisson_apply(jnp.asarray(x.reshape(-1)))) < 1e-15
    assert rel_err(tt.poisson_operator(n, flat=True)(to_torch(x.reshape(-1))),
                   gt.poisson_operator(n, flat=True)(jnp.asarray(x.reshape(-1)))) < 1e-15
    assert tt.poisson_spectral_bounds(n) == gt.poisson_spectral_bounds(n)
    np.testing.assert_array_equal(to_np(tt.poisson_matrix(4, dtype=torch.float32, device="cpu")),
                                  to_np(gt.poisson_matrix(4, dtype=jnp.float32)))

