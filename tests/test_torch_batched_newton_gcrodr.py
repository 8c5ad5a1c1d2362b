"""Batched Newton–Krylov with the gcrodr inner (``gmres_tpu_torch.
batched_solve`` with newton_krylov, ``inner="gcrodr"``): the Bratu λ-sweep
of tests/test_batched.py::test_vmap_newton_continuation as one batched
JFNK solve, each lane's recycle space its own across its Newton steps,
against gmres_tpu's ``jax.vmap`` of the same solve (Newton steps JAX's, x
within 1e-9: tests/test_torch_batched_newton.py's bands) and each lane
bitwise its sequential solve; and the reference's breakdown with the left
V-cycle and the Armijo line search, mirrored.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from tests.test_torch_batched_deflated import _check_lanes


def test_vmap_newton_continuation_gcrodr_inner():
    """tests/test_batched.py::test_vmap_newton_continuation with the gcrodr
    inner (recycle_k 10, restart 30): the Bratu λ-sweep as one batched JFNK
    solve, each lane's recycle space its own across its Newton steps."""
    from gmres_tpu.models.poisson import poisson_apply as pa_j
    from gmres_tpu_torch.models.poisson import poisson_apply as pa_t

    n = 16
    h2 = (1.0 / (n + 1)) ** 2
    lam_vals = [1.0, 3.0, 5.0, 6.5]
    lams = torch.tensor(lam_vals, dtype=torch.float64)
    kw = dict(tol=1e-10, inner="gcrodr", recycle_k=10, restart=30)

    def F(u, lam):
        return pa_t(u) - (lam * h2) * torch.exp(u)

    res = tt.batched_solve(tt.newton_krylov, F, torch.zeros((4, n, n), dtype=torch.float64),
                           lane_args=(lams,), **kw)
    assert bool(torch.all(res.status == tt.SolverStatus.CONVERGED))
    assert np.all(np.diff(res.x.amax(dim=(1, 2)).numpy()) > 0)
    singles = [tt.newton_krylov(lambda u, lam=lam: F(u, lam),
                                torch.zeros((n, n), dtype=torch.float64), **kw)
               for lam in lams]
    _check_lanes(res, singles, ("iterations", "status", "inner_iterations", "jv_products"))

    def solve(lam):
        f = lambda u: pa_j(u) - (lam * h2) * jnp.exp(u)  # noqa: E731
        return gt.newton_krylov(f, jnp.zeros((n, n)), **kw)

    rj = jax.jit(jax.vmap(solve))(jnp.asarray(lam_vals))
    for k in range(4):
        assert int(res.iterations[k]) == int(rj.iterations[k]), k
        np.testing.assert_allclose(res.x[k].numpy(), np.asarray(rj.x[k]), atol=1e-9)


def test_gcrodr_inner_with_the_cycle_breaks_down_as_in_gmres_tpu():
    """With the left V-cycle and the Armijo line search, the gcrodr inner
    stops the λ = 6.5 lane at its second Newton step with status 2
    (BREAKDOWN) at 64², in gmres_tpu's jax.vmap as in the port (a
    reference property, mirrored: the recycled space's projection alone
    meets the forcing term and its step fails the Armijo test); the λ = 1
    lane converges. Each lane is its sequential solve."""
    from gmres_tpu.models.poisson import poisson_apply as pa_j
    from gmres_tpu_torch.models.poisson import poisson_apply as pa_t

    n = 64
    h2 = (1.0 / (n + 1)) ** 2
    lam_vals = [1.0, 6.5]
    kw = dict(tol=1e-10, inner="gcrodr", recycle_k=10, restart=30)
    m = tt.poisson_multigrid_preconditioner(n)
    lams = torch.tensor(lam_vals, dtype=torch.float64)

    def F(u, lam):
        return pa_t(u) - (lam * h2) * torch.exp(u)

    res = tt.batched_solve(tt.newton_krylov, F, torch.zeros((2, n, n), dtype=torch.float64),
                           lane_args=(lams,), M=m, **kw)
    singles = [tt.newton_krylov(lambda u, lam=lam: F(u, lam),
                                torch.zeros((n, n), dtype=torch.float64), M=m, **kw)
               for lam in lams]
    _check_lanes(res, singles, ("iterations", "status", "inner_iterations", "jv_products"))
    mj = gt.poisson_multigrid_preconditioner(n)

    def solve(lam):
        f = lambda u: pa_j(u) - (lam * h2) * jnp.exp(u)  # noqa: E731
        return gt.newton_krylov(f, jnp.zeros((n, n)), M=mj, **kw)

    rj = jax.vmap(solve)(jnp.asarray(lam_vals))
    assert res.status.tolist() == [int(v) for v in rj.status] == [0, 2]
    assert res.iterations.tolist() == [int(v) for v in rj.iterations]

