"""Batched eigensolvers (``gmres_tpu_torch.batched_solve`` with lobpcg,
arnoldi_eigs and lanczos_bounds) over an operator family swept over lanes,
against gmres_tpu's ``jax.vmap`` of the same solve on the same numpy
inputs, and each lane against the port's own sequential solve.

Against the port's sequential solve: every lane's counts, status and
outputs (eigenvalues, eigenvectors, residuals, bounds) to the bit; the
batch's host reads the longest lane's; the operator's applications
between the longest lane's and all lanes' together, and the stencil's
(K1's route) and the cycle's smoother (K2's route) called on lane blocks.
Against JAX's vmapped lane, the sequential parity tests' tolerances
(tests/test_torch_lanczos.py, tests/test_torch_eigs.py): bounds within
1e-10 relative; LOBPCG with JAX's guard rows and fallback directions
patched in, eigenvalues within 1e-12, status equal and iterations equal
(the degenerate start within 3, LOBPCG_CASES);
Krylov–Schur eigenvalues within 1e-10 relative (as multisets free of the
conjugate pair's sign), restart cycles within 1.
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
from gmres_tpu_torch.ops import fused, stencil
from gmres_tpu_torch.solvers import lobpcg as tlobpcg
from tests.test_torch_eigs import _jax_fallback, _jax_guard, _keyed
from tests.torch_parity import rel_err, seeded, to_np, to_torch

SHIFTS = np.array([0.0, 0.5, 1.0])   # Poisson + s·I, one s a lane
GAMMAS = np.array([0.3, 0.4, 0.5])   # convection–diffusion γx (γy 0.2), one a lane


class Counted:
    """A single-lane operator A(v, *lane_args) that counts its calls (under
    vmap one call a group of lanes)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, v, *args):
        self.calls += 1
        return self.fn(v, *args)


def _family(pkg, model, n):
    """(A(v, p), parameters) of the lanes' operator family."""
    if model == "poisson":
        op = pkg.poisson_operator(n)
        return (lambda v, s: op(v) + s * v), SHIFTS
    cd = cd_j if pkg is gt else cd_t
    return (lambda v, g: cd(v, g, 0.2)), GAMMAS


def _batched_and_singles(solver, model, n, bs, kw, **extra):
    """The batched solve on the counted family, then each lane's sequential
    solve on its own counted operator; (result, singles, batch calls, lanes'
    calls, K1 block calls, K2 block calls)."""
    fam, params = _family(tt, model, n)
    a = Counted(fam)
    k1 = stencil.stencil_5pt_pallas.block_calls
    k2 = fused.poly_stencil_smoother_pallas.block_calls
    res = tt.batched_solve(solver, a, to_torch(bs), lane_args=(to_torch(params),), **kw,
                           **extra)
    k1 = stencil.stencil_5pt_pallas.block_calls - k1
    k2 = fused.poly_stencil_smoother_pallas.block_calls - k2
    singles, calls = [], []
    for k, p in enumerate(to_torch(params)):
        one = Counted(fam)
        singles.append(solver(lambda v, one=one, p=p: one(v, p), to_torch(bs[k]), **kw,
                              **extra))
        calls.append(one.calls)
    return res, singles, a.calls, calls, k1, k2


def _check_batch(res, singles, batch_calls, calls):
    assert res.host_syncs == max(s.host_syncs for s in singles)
    assert max(calls) <= batch_calls <= sum(calls), (batch_calls, calls)


@pytest.mark.parametrize("rigorous", [True, False])
def test_lanczos_bounds_over_shift_lanes(rigorous):
    """k-step Lanczos on Poisson 16² + s·I: one application a step for
    every lane (one block call of K1's route), bounds bitwise the
    sequential runs' and within 1e-10 of JAX's vmapped lanes."""
    n, steps = 16, 20
    probes = seeded(3, (len(SHIFTS), n, n))
    fam, _ = _family(tt, "poisson", n)
    a = Counted(fam)
    k1 = stencil.stencil_5pt_pallas.block_calls
    lo, hi = tt.batched_solve(tt.lanczos_bounds, a, to_torch(probes),
                              lane_args=(to_torch(SHIFTS),), steps=steps, rigorous=rigorous)
    assert a.calls == stencil.stencil_5pt_pallas.block_calls - k1 == steps
    assert lo.shape == hi.shape == (len(SHIFTS),)
    for k, s in enumerate(to_torch(SHIFTS)):
        lo_k, hi_k = tt.lanczos_bounds(lambda v, s=s: fam(v, s), to_torch(probes[k]),
                                       steps=steps, rigorous=rigorous)
        assert torch.equal(lo[k], lo_k) and torch.equal(hi[k], hi_k), k
    famj, _ = _family(gt, "poisson", n)
    lo_j, hi_j = jax.vmap(lambda p, s: gt.lanczos_bounds(lambda v: famj(v, s), p, steps,
                                                         rigorous=rigorous))(
        jnp.asarray(probes), jnp.asarray(SHIFTS))
    np.testing.assert_allclose(to_np(lo), np.asarray(lo_j), rtol=1e-10, atol=0)
    np.testing.assert_allclose(to_np(hi), np.asarray(hi_j), rtol=1e-10, atol=0)


# label: (n, k, keywords, iteration band against JAX): "mg" the Poisson
# cycle as M (shared by the lanes), "B" a diagonal mass operator,
# "degenerate" a duplicated and a zero row in each lane's X0. The
# duplicated row's direction is SVQB's clamped null vector, rounding noise,
# so that case's count follows rounding: at s = 0.5 the port takes 15
# iterations and gmres_tpu 12, sequentially as batched in each package
# (their residuals part by the 8th iteration); it is held within 3, its
# eigenvalues to 1e-12 as every case's.
LOBPCG_CASES = {
    "mg-guard": (16, 3, {"tol": 1e-9, "mg": True, "guard": 2}, 0),
    "pencil": (12, 2, {"tol": 1e-7, "B": True, "mg": True}, 0),
    "degenerate": (16, 3, {"tol": 1e-9, "mg": True, "degenerate": True}, 3),
}


def _lobpcg_setup(pkg, label):
    n, k, kw, _ = LOBPCG_CASES[label]
    kw = dict(kw)
    x0 = seeded(41, (len(SHIFTS), k, n, n))
    if kw.pop("degenerate", False):
        x0[:, 1] = x0[:, 0]
        x0[:, 2] = 0.0
    if kw.pop("mg", False):
        kw["M"] = pkg.poisson_multigrid_preconditioner(n)
    if kw.pop("B", False):
        w = 1.0 + 0.5 * seeded(40, (n, n)) ** 2
        wp = jnp.asarray(w) if pkg is gt else to_torch(w)
        kw["B"] = lambda v: wp * v
    return n, x0, kw


@pytest.mark.parametrize("label", sorted(LOBPCG_CASES))
def test_lobpcg_over_shift_lanes(label, monkeypatch):
    """LOBPCG on Poisson + s·I, a lane a shift: the lanes' block
    applications of A, M (and B) one nested vmap each; every lane its
    sequential solve's bits and JAX's vmapped lane's eigenvalues."""
    monkeypatch.setattr(tlobpcg, "_guard_rows", _jax_guard)
    monkeypatch.setattr(tlobpcg, "_fallback_rows", _jax_fallback)
    n, x0, kw = _lobpcg_setup(tt, label)
    res, singles, batch_calls, calls, k1, k2 = _batched_and_singles(
        tt.lobpcg, "poisson", n, x0, kw)
    for k, one in enumerate(singles):
        assert int(res.iterations[k]) == one.iterations and int(res.status[k]) == one.status
        for name in ("eigenvalues", "x", "residuals"):
            assert torch.equal(getattr(res, name)[k], getattr(one, name)), (name, k)
    _check_batch(res, singles, batch_calls, calls)
    assert k1 > 0 and k2 > 0
    _, _, kwj = _lobpcg_setup(gt, label)
    famj, _ = _family(gt, "poisson", n)
    rj = jax.vmap(lambda x, s: gt.lobpcg(lambda v: famj(v, s), x, **kwj))(
        jnp.asarray(x0), jnp.asarray(SHIFTS))
    for k in range(len(SHIFTS)):
        band = LOBPCG_CASES[label][3]
        assert abs(int(res.iterations[k]) - int(rj.iterations[k])) <= band, k
        assert int(res.status[k]) == int(rj.status[k]) == 0, k
        assert np.max(np.abs(to_np(res.eigenvalues[k]) - np.asarray(rj.eigenvalues[k]))) \
            < 1e-12, k


# label: (model, n, keywords)
ARNOLDI_CASES = {
    "convdiff-gamma": ("convdiff", 16, {"nev": 4, "steps": 20, "tol": 1e-10}),
    "poisson-shift-SR": ("poisson", 12, {"nev": 3, "steps": 20, "tol": 1e-10, "which": "SR"}),
}


@pytest.mark.parametrize("label", sorted(ARNOLDI_CASES))
def test_arnoldi_eigs_over_operator_lanes(label):
    """Krylov–Schur on a complex basis over an operator family (a real A:
    two vmapped applications a complex matvec): each lane its sequential
    solve's bits, the Rayleigh blocks one read a cycle; the eigenvalues
    within 1e-10 of JAX's vmapped lanes, cycles within 1."""
    model, n, kw = ARNOLDI_CASES[label]
    probes = seeded(1, (3, n, n))
    res, singles, batch_calls, calls, k1, _ = _batched_and_singles(
        tt.arnoldi_eigs, model, n, probes, kw)
    for k, one in enumerate(singles):
        assert int(res.iterations[k]) == one.iterations and int(res.status[k]) == one.status
        for name in ("eigenvalues", "x", "residuals"):
            assert torch.equal(getattr(res, name)[k], getattr(one, name)), (name, k)
    _check_batch(res, singles, batch_calls, calls)
    assert all(c % 2 == 0 for c in calls) and k1 > 0
    famj, params = _family(gt, model, n)
    rj = jax.vmap(lambda p, q: gt.arnoldi_eigs(lambda v: famj(v, q), p, **kw))(
        jnp.asarray(probes), jnp.asarray(params))
    for k in range(3):
        assert int(res.status[k]) == int(rj.status[k]) == 0, k
        assert abs(int(res.iterations[k]) - int(rj.iterations[k])) <= 1, k
        lam, jlam = _keyed(to_np(res.eigenvalues[k])), _keyed(rj.eigenvalues[k])
        assert np.max(np.abs(lam - jlam)) < 1e-10 * np.max(np.abs(jlam)), k
        assert np.all(to_np(res.residuals[k]) < kw["tol"]), k
        assert rel_err(np.linalg.norm(to_np(res.x[k]).reshape(kw["nev"], -1), axis=1),
                       np.ones(kw["nev"])) < 1e-12
