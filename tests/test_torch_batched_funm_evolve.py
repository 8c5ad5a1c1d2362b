"""Batched matrix functions and time steppers (``gmres_tpu_torch.batched_solve``
with funm_lanczos, expm_multiply, trace_funm, theta_evolve and
exponential_evolve) over an operator family swept over lanes, against
gmres_tpu's ``jax.vmap`` of the same call on the same numpy inputs, and
each lane against the port's own sequential call.

Against the port's sequential call: every lane's outputs (y, the error
estimates, SLQ samples, states and trajectories, per-step counts and
statuses) to the bit; the batch's host reads the longest lane's; the
operator's applications between the longest lane's and all lanes' (equal
to one lane's where the lanes run in lockstep: the factorizations), and
K1's route called on lane blocks. Against JAX's vmapped lane, the
tolerances of tests/test_torch_funm_evolve.py: y, samples and exponential
Euler's states within 1e-12 relative, error estimates within 1e-12·‖b‖;
θ-method per-step counts within 2 and every state within 1e-10 relative.
JAX's Rademacher probes are patched in through ``funm._rademacher``.
"""

import functools

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
from gmres_tpu_torch.solvers import funm as tfunm
from tests.test_torch_batched_spectral import Counted
from tests.torch_parity import rel_err, seeded, to_np, to_torch

N = 16
SHIFTS = np.array([0.0, 0.5, 1.0])   # Poisson + s·I, one s a lane
GAMMAS = np.array([0.3, 0.4, 0.5])   # funm's convection–diffusion γx (γy 0.2)
EVOLVE_GAMMAS = np.array([1.5, 2.0, 2.5])  # θ-steps' γx (γy 1.0), around the parity test's 2


def _family(pkg, model):
    """(A(v, p), parameters) of the lanes' operator family at N²."""
    if model == "poisson":
        op = pkg.poisson_operator(N)
        return (lambda v, s: op(v) + s * v), SHIFTS
    cd = cd_j if pkg is gt else cd_t
    if model == "convdiff":
        return (lambda v, g: cd(v, g, 0.2)), GAMMAS
    return (lambda v, g: cd(v, g, 1.0)), EVOLVE_GAMMAS


def _batched_and_singles(solver, model, bs, kw):
    """The batched call on the counted family, then each lane's sequential
    call on its own counted operator; (result, singles, batch calls, lanes'
    calls, K1 block calls, K2 block calls)."""
    fam, params = _family(tt, model)
    a = Counted(fam)
    k1 = stencil.stencil_5pt_pallas.block_calls
    k2 = fused.poly_stencil_smoother_pallas.block_calls
    res = tt.batched_solve(solver, a, to_torch(bs), lane_args=(to_torch(params),), **kw)
    k1 = stencil.stencil_5pt_pallas.block_calls - k1
    k2 = fused.poly_stencil_smoother_pallas.block_calls - k2
    kw = dict(kw)
    pos = (kw.pop("f"),) if "f" in kw else ()
    singles, calls = [], []
    for k, p in enumerate(to_torch(params)):
        one = Counted(fam)
        lane = (lambda v, one=one, p=p: one(v, p))
        if solver is tt.trace_funm:
            singles.append(solver(lane, *pos, to_torch(bs[k]), **kw))
        else:
            singles.append(solver(lane, to_torch(bs[k]), *pos, **kw))
        calls.append(one.calls)
    assert res.host_syncs == max(s.host_syncs for s in singles)
    assert max(calls) <= a.calls <= sum(calls), (a.calls, calls)
    return res, singles, a.calls, calls, k1, k2


def _same_bits(res, singles, names):
    for k, one in enumerate(singles):
        for name in names:
            got, want = getattr(res, name)[k], getattr(one, name)
            if isinstance(want, torch.Tensor):
                assert torch.equal(got, want), (name, k)
            else:
                assert int(got) == int(want), (name, k)


def _jax_lanes(call, model, lanes_in):
    """JAX's jax.vmap of call(A_lane, x) over (x, the lane's parameter)."""
    famj, params = _family(gt, model)
    return jax.vmap(lambda x, p: call(lambda v: famj(v, p), x))(
        jnp.asarray(lanes_in), jnp.asarray(params))


@pytest.mark.parametrize("model", ["poisson", "convdiff"])
def test_funm_lanczos_over_operator_lanes(model):
    """A^{−1/2}·b, 20 Lanczos steps a lane: the lanes' factorizations in
    lockstep (one application a step, a block call of K1's route), their
    Hessenbergs one read."""
    bs = seeded(1, (3, N, N))
    res, singles, calls, lane_calls, k1, _ = _batched_and_singles(
        tt.funm_lanczos, model, bs, {"f": lambda s: 1 / torch.sqrt(s), "steps": 20})
    assert calls == k1 == lane_calls[0] == 20 and res.host_syncs == 1
    _same_bits(res, singles, ("y", "error_estimate", "asymmetry"))
    rj = _jax_lanes(lambda A, b: gt.funm_lanczos(A, b, lambda s: 1 / jnp.sqrt(s), steps=20),
                    model, bs)
    for k in range(3):
        assert rel_err(res.y[k], rj.y[k]) < 1e-12, k
        assert abs(float(res.error_estimate[k]) - float(rj.error_estimate[k])) \
            < 1e-12 * np.linalg.norm(bs[k]), k
        if model == "poisson":
            assert float(res.asymmetry[k]) < 1e-13
        else:
            assert abs(float(res.asymmetry[k]) - float(rj.asymmetry[k])) < 1e-12


@pytest.mark.parametrize("t", [0.3, (0.1, 0.5, 2.0)])
def test_expm_multiply_over_shift_lanes(t):
    bs = seeded(2, (3, N, N))
    res, singles, calls, _, k1, _ = _batched_and_singles(
        tt.expm_multiply, "poisson", bs, {"t": t, "steps": 20})
    assert calls == k1 == 20 and res.host_syncs == 1
    _same_bits(res, singles, ("y", "error_estimate", "asymmetry"))
    rj = _jax_lanes(lambda A, b: gt.expm_multiply(A, b, jnp.asarray(t), steps=20),
                    "poisson", bs)
    assert tuple(res.y.shape) == tuple(rj.y.shape)
    for k in range(3):
        assert rel_err(res.y[k], rj.y[k]) < 1e-12, k
        assert np.max(np.abs(to_np(res.error_estimate[k]) - np.asarray(rj.error_estimate[k]))) \
            < 1e-12 * np.linalg.norm(bs[k]), k


def test_trace_funm_over_shift_lanes_with_jax_probes(monkeypatch):
    """log det of Poisson + s·I, 6 probes a lane: the 3 × 6 factorizations
    one lane each of the runner, each probe with its lane's shift, so each
    Arnoldi step is one application (one block call) for all 18, and every
    Hessenberg one read; each lane's samples its sequential call's."""
    z = np.asarray(jax.random.rademacher(jax.random.PRNGKey(0), (6, N, N), dtype=jnp.float64))
    monkeypatch.setattr(tfunm, "_rademacher",
                        lambda n_probes, shape, dtype, device, key: to_torch(z).to(device, dtype))
    likes = np.zeros((3, N, N))
    res, singles, calls, lane_calls, k1, _ = _batched_and_singles(
        tt.trace_funm, "poisson", likes, {"f": torch.log, "n_probes": 6, "steps": 20})
    assert calls == k1 == lane_calls[0] == 20 and res.host_syncs == 1
    assert tuple(res.samples.shape) == (3, 6)
    _same_bits(res, singles, ("samples", "value", "stderr"))
    rj = _jax_lanes(lambda A, x: gt.trace_funm(A, jnp.log, x, n_probes=6, steps=20),
                    "poisson", likes)
    for k in range(3):
        for name in ("samples", "value", "stderr"):
            assert rel_err(getattr(res, name)[k], getattr(rj, name)[k]) < 1e-12, (name, k)


def _shifted_cycle(pkg):
    """The convection–diffusion cycle for L + 2I at γ (2.0, 1.0), over 0.5:
    an M for S = I + 0.5·L (dt 1, Crank–Nicolson), shared by the lanes."""
    cyc = pkg.convection_diffusion_multigrid_preconditioner(N, 2.0, 1.0, shift=2.0)
    return lambda r: cyc(r) / 0.5


def _poisson_cycle(pkg):
    """The Poisson V-cycle over θ·dt (= 0.5): an SPD M for S."""
    cyc = pkg.poisson_multigrid_preconditioner(N)
    return lambda r: cyc(r) / 0.5


def _forcing(pkg):
    f = seeded(9, (N, N))
    fp = jnp.asarray(f) if pkg is gt else to_torch(f)
    sin = jnp.sin if pkg is gt else torch.sin
    return lambda t: sin(t) * fp


# label: (solver, model, extra keyword arguments): tests/test_torch_funm_evolve.py's
# cases over lanes, and cg and gcrodr with a cycle as M.
EVOLVE_CASES = {
    "cg": ("cg", "poisson", {}),
    "cg-mg": ("cg", "poisson", {"M": _poisson_cycle}),
    "bicgstab": ("bicgstab", "evolve", {}),
    "gmres": ("gmres", "evolve", {}),
    "gcrodr": ("gcrodr", "evolve", {}),
    "gcrodr-cycle": ("gcrodr", "evolve", {"M": _shifted_cycle}),
    "cg-forcing-ab2": ("cg", "poisson", {"forcing": _forcing,
                                         "explicit": lambda pkg: (lambda u: 0.1 * u * u)}),
    "cg-backward-euler": ("cg", "poisson", {"theta": 1.0, "explicit_order": 1,
                                            "explicit": lambda pkg: (lambda u: 0.1 * u * u)}),
}


def _evolve_kw(pkg, label):
    solver, _, extra = EVOLVE_CASES[label]
    kw = {k: (v(pkg) if callable(v) else v) for k, v in extra.items()}
    return dict(dt=1.0, n_steps=5, solver=solver, tol=1e-11, restart=20, recycle_k=4,
                save_trajectory=True, **kw)


@functools.lru_cache(maxsize=None)
def _jax_evolve(label):
    kw = _evolve_kw(gt, label)
    return _jax_lanes(lambda A, u0: gt.theta_evolve(A, u0, **kw), EVOLVE_CASES[label][1],
                      seeded(3, (3, N, N)))


@pytest.mark.parametrize("label", sorted(EVOLVE_CASES))
def test_theta_evolve_over_operator_lanes(label):
    """Crank–Nicolson (or backward Euler), 5 steps a lane: the shifted
    operator derived once for the lanes (its applications vmapped), each
    step's solve the lane's own steps (gcrodr's recycle block its own)."""
    u0 = seeded(3, (3, N, N))
    res, singles, _, _, k1, k2 = _batched_and_singles(
        tt.theta_evolve, EVOLVE_CASES[label][1], u0, _evolve_kw(tt, label))
    _same_bits(res, singles, ("u", "iterations", "residuals", "statuses", "status",
                              "inner_total", "trajectory"))
    # The Poisson cycle smooths through K2's route; the 16² convdiff cycle
    # is one level, its coarse solve K1 sweeps.
    assert k1 > 0 and (k2 > 0) == (label == "cg-mg")
    rj = _jax_evolve(label)
    for k in range(3):
        assert int(res.status[k]) == int(rj.status[k]) == 0, k
        assert np.max(np.abs(to_np(res.iterations[k]) - np.asarray(rj.iterations[k]))) <= 2, k
        assert to_np(res.statuses[k]).tolist() == np.asarray(rj.statuses[k]).tolist()
        for i in range(res.trajectory.shape[1]):
            assert rel_err(res.trajectory[k, i], rj.trajectory[k, i]) < 1e-10, (k, i)


def test_exponential_evolve_over_shift_lanes():
    """Exponential Euler, a constant forcing shared by the lanes: the
    forcing propagator and each step one factorization a lane, in
    lockstep (one application a Krylov step for all lanes)."""
    u0, f = seeded(4, (3, N, N)), seeded(5, (N, N))
    kw = dict(dt=0.5, n_steps=3, steps=20, save_trajectory=True)
    res, singles, calls, _, k1, _ = _batched_and_singles(
        tt.exponential_evolve, "poisson", u0, {**kw, "forcing": to_torch(f)})
    assert calls == k1 == 4 * 20 and res.host_syncs == 4
    _same_bits(res, singles, ("u", "error_estimates", "trajectory"))
    rj = _jax_lanes(lambda A, u: gt.exponential_evolve(A, u, forcing=jnp.asarray(f), **kw),
                    "poisson", u0)
    for k in range(3):
        assert rel_err(res.u[k], rj.u[k]) < 1e-12, k
        assert rel_err(res.trajectory[k], rj.trajectory[k]) < 1e-12, k
        assert np.max(np.abs(to_np(res.error_estimates[k]) - np.asarray(rj.error_estimates[k]))) \
            < 1e-12 * np.linalg.norm(u0[k]), k
