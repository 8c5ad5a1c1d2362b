"""The 3-D Poisson model and its multigrid cycle in the PyTorch port against
gmres_tpu on the same numpy inputs, on the CPU, float64.

The 7-point stencil, ``poisson3d_matrix`` and the transfers
(``restrict_sum3d``, ``prolong_repeat3d``) are JAX's bit for bit (the same
operations in the same order); the spectral bounds are the same floats.
One V-cycle application within 1e-13 of JAX's relative to max|z|; CG with
the cycle at 16³ (the grid of tests/test_poisson3d.py:73-83 that a CI box
runs in seconds): iterations and status equal, x within 1e-10 relative;
``levels`` and ``fine_equiv_sweeps`` equal. The ``mesh=`` cycle on a
one-rank mesh is the plain cycle (2 and 4 ranks:
tests/test_torch_dist_models.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu.precond.multigrid import (
    poisson3d_multigrid_preconditioner as jax_cycle,
    prolong_repeat3d as jax_prolong,
    restrict_sum3d as jax_restrict,
)
from gmres_tpu_torch.precond.multigrid import prolong_repeat3d, restrict_sum3d
from tests.torch_parity import rel_err, seeded, to_np, to_torch


@pytest.mark.parametrize("nsize", [4, 5, 7])
def test_stencil_and_matrix_match_jax(nsize):
    x = seeded(100, (nsize, nsize, nsize))
    np.testing.assert_array_equal(to_np(tt.poisson3d_apply(to_torch(x))),
                                  np.asarray(gt.poisson3d_apply(jnp.asarray(x))))
    dense = to_np(tt.poisson3d_matrix(nsize, device="cpu"))
    np.testing.assert_array_equal(dense, np.asarray(gt.poisson3d_matrix(nsize)))
    np.testing.assert_allclose(dense @ x.reshape(-1), to_np(
        tt.poisson3d_operator(nsize)(to_torch(x))).reshape(-1), atol=1e-13)
    assert tt.poisson3d_spectral_bounds(nsize) == gt.poisson3d_spectral_bounds(nsize)


def test_transfers_match_jax_and_are_adjoint_up_to_half():
    x, y = seeded(101, (8, 8, 8)), seeded(102, (4, 4, 4))
    rx = restrict_sum3d(to_torch(x))
    py = prolong_repeat3d(to_torch(y))
    np.testing.assert_array_equal(to_np(rx), np.asarray(jax_restrict(jnp.asarray(x))))
    np.testing.assert_array_equal(to_np(py), np.asarray(jax_prolong(jnp.asarray(y))))
    np.testing.assert_allclose(float((rx * to_torch(y)).sum()),
                               0.5 * float((to_torch(x) * py).sum()), rtol=1e-13)


@pytest.mark.parametrize("nsize", [8, 16])
def test_cycle_matches_jax(nsize):
    r = seeded(103, (nsize,) * 3)
    mj, mt = jax_cycle(nsize), tt.poisson3d_multigrid_preconditioner(nsize)
    assert (mt.levels, mt.fine_equiv_sweeps) == (mj.levels, mj.fine_equiv_sweeps)
    assert rel_err(mt(to_torch(r)), mj(jnp.asarray(r))) <= 1e-13


def test_cg_with_the_cycle_matches_jax():
    n = 16
    b = np.asarray(gt.poisson3d_operator(n)(jnp.ones((n, n, n))))
    rj = gt.cg(gt.poisson3d_operator(n), jnp.asarray(b), tol=1e-9, max_iterations=300,
               M=jax_cycle(n))
    rt = tt.cg(tt.poisson3d_operator(n), to_torch(b), tol=1e-9, max_iterations=300,
               M=tt.poisson3d_multigrid_preconditioner(n))
    assert (rt.iterations, rt.status) == (int(rj.iterations), int(rj.status)) and rt.converged
    assert rel_err(rt.x, rj.x) <= 1e-10
    np.testing.assert_allclose(to_np(rt.x), 1.0, atol=1e-8)


def test_distributed_cycle_and_bad_sizes_raise(tmp_path):
    """The distributed cycle (ROADMAP item 8.3b, once NotImplementedError):
    on a one-rank mesh, with the 8³ level replicated, one application is
    the plain cycle within 1e-13 relative; replicate_below without a mesh is
    ignored, as in gmres_tpu. A size the levels do not divide raises."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from tests.torch_parity import one_rank_mesh

    r = to_torch(np.random.default_rng(6).standard_normal((16, 16, 16)))
    plain = tt.poisson3d_multigrid_preconditioner(16)(r)
    with one_rank_mesh(str(tmp_path)) as mesh:
        dm = tt.poisson3d_multigrid_preconditioner(16, mesh=mesh, replicate_below=16)
        assert (dm.replicate_from, dm.levels) == (1, 2)
        assert rel_err(dm(distribute_tensor(r, mesh, [Shard(0)])).full_tensor(), plain) <= 1e-13
    ignored = tt.poisson3d_multigrid_preconditioner(16, replicate_below=8)
    assert rel_err(ignored(r), plain) == 0
    with pytest.raises(ValueError, match="not divisible"):
        tt.poisson3d_multigrid_preconditioner(12, levels=4)
