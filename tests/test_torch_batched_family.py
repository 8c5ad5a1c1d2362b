"""Batched solves of the short recurrences (``gmres_tpu_torch.batched_solve``
with minres, cgs, tfqmr, bicgstabl, idrs, chebyshev_solve and sstep_cg)
against gmres_tpu's ``jax.vmap`` of the same solve on the same seeded numpy
inputs, and each lane against the port's own sequential solve.

Against the port's sequential solve: iterations, status, residual history
and x bitwise (each lane runs its sequential solve's steps; one
application of A or M a step for the lanes together). Against JAX's
vmapped lane: the same status, the iterations within the band the
solver's sequential parity test already pins (0: test_torch_nonsym.py at
16² without a preconditioner and at 32² with the cycle, here 24²;
test_torch_minres_sstep_cg.py, test_torch_chebyshev_solve.py,
test_torch_block_idrs.py with JAX's shadow block), and x within the
tolerance of that file (relative to max|x|: 1e-6 for the nonsymmetric
recurrences, 1e-9 for MINRES, s-step CG and Chebyshev, 1e-8 for IDR(s)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu.models.convection_diffusion import convection_diffusion_apply as cd_j
from gmres_tpu.solvers.sstep_cg import sstep_cg as jax_sstep_cg
from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_apply as cd_t
from gmres_tpu_torch.solvers import idrs as tidrs
from tests.torch_parity import rel_err, seeded, to_torch

LANES = 3
CHEB = {"lam_min": 8.0 * np.sin(np.pi / 34) ** 2, "lam_max": 8.0}
# label: (solver name, problem (model, n, preconditioner), keywords, x tolerance).
CASES = {
    "minres": ("minres", ("poisson", 12, None), {"tol": 1e-9}, 1e-9),
    "minres-mg": ("minres", ("poisson", 16, "mg"), {"tol": 1e-9}, 1e-9),
    "cgs": ("cgs", ("convdiff", 16, None), {"tol": 1e-9}, 1e-6),
    "cgs-rtol": ("cgs", ("convdiff", 16, None), {"tol": 1e-9, "rtol": 1e-8}, 1e-6),
    "tfqmr": ("tfqmr", ("convdiff", 16, None), {"tol": 1e-9}, 1e-6),
    "tfqmr-mg": ("tfqmr", ("convdiff", 24, "mg"), {"tol": 1e-9}, 1e-6),
    "bicgstabl": ("bicgstabl", ("convdiff", 16, None), {"tol": 1e-9}, 1e-6),
    "bicgstabl-ell4-mg": ("bicgstabl", ("convdiff", 24, "mg"), {"tol": 1e-9, "ell": 4},
                          1e-6),
    "idrs": ("idrs", ("convdiff", 16, None), {"tol": 1e-9, "s": 4}, 1e-8),
    "chebyshev": ("chebyshev_solve", ("poisson", 16, None),
                  dict(CHEB, order=8, tol=1e-9), 1e-9),
    "chebyshev-coefs": ("chebyshev_solve", ("poisson", 16, None),
                        dict(CHEB, order=8, tol=1e-9, coefs=(4.0, -1.0, -1.0, -1.0, -1.0)),
                        1e-9),
    "sstep_cg": ("sstep_cg", ("poisson", 12, None), {"tol": 1e-9, "s": 4}, 1e-9),
    "sstep_cg-mg": ("sstep_cg", ("poisson", 24, "mg"), {"tol": 1e-10, "s": 4}, 1e-9),
}


def _jax_solver(name):
    return jax_sstep_cg if name == "sstep_cg" else getattr(gt, name)


def _problem(pkg, spec):
    """(A, M) of one package for a problem spec."""
    model, n, precond = spec
    if model == "poisson":
        op = pkg.poisson_operator(n)
        m = pkg.poisson_multigrid_preconditioner(n) if precond else None
    else:
        op = pkg.convection_diffusion_operator(n, 0.4, 0.2)
        m = pkg.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2) if precond else None
    return op, m


def _call(solver, op, b, m, kw):
    """solver on one b, chebyshev_solve's bounds passed by position."""
    kw = dict(kw)
    if m is not None:
        kw["M"] = m
    if "lam_min" in kw:
        return solver(op, b, kw.pop("lam_min"), kw.pop("lam_max"), **kw)
    return solver(op, b, **kw)


def _jax_shadow(s, shape):
    """JAX's IDR(s) shadow block (PRNGKey(7) normal draws, orthonormalised
    as gmres_tpu does), as numpy."""
    from gmres_tpu.solvers.block_gmres import _orthonormalize_block

    raw = jax.random.normal(jax.random.PRNGKey(7), (s,) + tuple(shape), dtype=jnp.float64)
    p, _ = _orthonormalize_block(raw, float(jnp.finfo(jnp.float64).eps))
    return np.asarray(p)


def _check_lanes(res, singles, fields=("iterations", "status")):
    """Each lane bitwise its sequential solve: counts, history and x."""
    for k, single in enumerate(singles):
        for name in fields:
            assert int(getattr(res, name)[k]) == int(getattr(single, name)), (name, k)
        assert torch.equal(res.residual_history[k], single.residual_history), k
        assert torch.equal(res.x[k], single.x), k


@pytest.mark.parametrize("label", list(CASES))
def test_batched_matches_sequential_and_jax_vmap(label, monkeypatch):
    name, spec, kw, x_tol = CASES[label]
    n = spec[1]
    bs = seeded(300 + n, (LANES, n, n))
    if name == "idrs":
        p = _jax_shadow(kw["s"], (n, n))
        monkeypatch.setattr(tidrs, "_shadow_block",
                            lambda s_, shape, dtype, device: to_torch(p, device).to(dtype))
    opj, mj = _problem(gt, spec)
    rj = jax.vmap(lambda b: _call(_jax_solver(name), opj, b, mj, kw))(jnp.asarray(bs))
    opt, mt = _problem(tt, spec)
    solver = getattr(tt, name)
    bkw = dict(kw, M=mt) if mt is not None else dict(kw)
    res = tt.batched_solve(solver, opt, to_torch(bs), **bkw)
    singles = [_call(solver, opt, to_torch(bs[k]), mt, kw) for k in range(LANES)]
    _check_lanes(res, singles)
    assert res.host_syncs == max(s.host_syncs for s in singles)
    for k in range(LANES):
        assert int(res.status[k]) == int(rj.status[k]) == 0, k
        assert int(res.iterations[k]) == int(rj.iterations[k]), (k, res.iterations, rj.iterations)
        assert rel_err(res.x[k], np.asarray(rj.x[k])) <= x_tol, k


@pytest.mark.parametrize("name", ["cgs", "tfqmr", "bicgstabl", "idrs"])
def test_batched_over_convection_strengths(name):
    """One batched solve sweeps γ over the lanes, A(v, γ) with γ split per
    lane (K1's route with per-lane coefficients), around one shared
    convection–diffusion cycle as M: each lane bitwise its sequential solve
    on its own operator."""
    n = 24
    g = torch.tensor([0.2, 0.3, 0.4, 0.5], dtype=torch.float64)
    m = tt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)

    def op(v, gx):
        return cd_t(v, gx, 0.5 * gx)

    ones = torch.ones((n, n), dtype=torch.float64)
    bs = torch.stack([op(ones, gx) for gx in g])
    solver = getattr(tt, name)
    res = tt.batched_solve(solver, op, bs, lane_args=(g,), M=m, tol=1e-9)
    singles = [solver(lambda v, gx=gx: op(v, gx), bs[k], M=m, tol=1e-9)
               for k, gx in enumerate(g)]
    _check_lanes(res, singles)
    assert bool(torch.all(res.status == 0))
    np.testing.assert_allclose(res.x.numpy(), 1.0, atol=1e-7)


def test_gamma_sweep_matches_jax_vmap():
    """The γ sweep of TFQMR without a preconditioner at 16² against JAX's
    jax.vmap over γ: the counts equal, x within 1e-6."""
    n = 16
    gammas = np.asarray([0.2, 0.3, 0.4, 0.5])

    def solve_j(gx):
        op = lambda v: cd_j(v, gx, 0.5 * gx)  # noqa: E731
        return gt.tfqmr(op, op(jnp.ones((n, n))), tol=1e-9)

    rj = jax.vmap(solve_j)(jnp.asarray(gammas))
    g = to_torch(gammas)

    def op(v, gx):
        return cd_t(v, gx, 0.5 * gx)

    ones = torch.ones((n, n), dtype=torch.float64)
    res = tt.batched_solve(tt.tfqmr, op, torch.stack([op(ones, gx) for gx in g]),
                           lane_args=(g,), tol=1e-9)
    for k in range(len(gammas)):
        assert int(res.iterations[k]) == int(rj.iterations[k]) and int(res.status[k]) == 0
        assert rel_err(res.x[k], np.asarray(rj.x[k])) <= 1e-6
