"""s-step GMRES, FGMRES and LGMRES of the PyTorch port against gmres_tpu on
the same numpy inputs, on the CPU, float64 unless a case says otherwise.

Each case runs the JAX solver once (cached for the module) and the port's.
Tolerances: restarts and final-cycle iterations equal; the same status;
x within 1e-9 of JAX's relative to max|x| (a float32 work dtype: 1e-6);
residual histories within 1e-6; the final residual within 1e-6 relative
(a float32 work dtype: 1e-2, the float32 rounding of the last update).
The s-step cycles solve a Gram system whose condition is the square of the
monomial basis's, so the last-bit differences of the block's vectors (the
packages' Chebyshev applications differ by ~1e-15) move the per-cycle
residual by up to ~1e-2
relative (a float32 block: ~3e-2): their histories and final residuals are
held to 2e-2 relative (float32: 1e-1; 1e-14 absolute), and
``test_sstep_history_moves_with_ulp_rounding`` pins the mechanism on the
port alone. Host reads follow each solver's docstring.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from tests.torch_parity import one_rank_mesh, rel_err, seeded, to_np, to_torch

# label: (solver, problem, keyword arguments). Problems: ("poisson", n,
# preconditioner), ("convdiff", n, preconditioner) at γ = (0.4, 0.2),
# ("dense", n) the n²-order Poisson matrix, ("1x1",).
CASES = {
    "sstep-cheb16": ("sstep", ("poisson", 24, "cheb16"), {"s": 8, "tol": 1e-8}),
    "sstep-cheb16-f32": ("sstep", ("poisson", 24, "cheb16"),
                         {"s": 8, "tol": 1e-8, "inner": "float32"}),
    "sstep-plain-s3": ("sstep", ("poisson", 12, None), {"s": 3, "tol": 1e-8}),
    "sstep-x0": ("sstep", ("poisson", 16, "cheb16"), {"s": 6, "tol": 1e-9, "x0": True}),
    "sstep-max-restarts": ("sstep", ("poisson", 16, "cheb16"),
                           {"s": 4, "tol": 1e-12, "max_restarts": 2}),
    "sstep-zero-b": ("sstep", ("poisson", 8, "cheb16"), {"s": 4, "zero_b": True}),
    "sstep-dense": ("sstep", ("dense", 6), {"s": 6, "tol": 1e-10}),
    "fgmres-cbpr2": ("fgmres", ("poisson", 24, "cbpr2"), {"restart": 10, "tol": 1e-10}),
    "fgmres-inner-cg": ("fgmres", ("poisson", 16, "cg4"), {"restart": 10, "tol": 1e-8}),
    "fgmres-mg": ("fgmres", ("convdiff", 32, "mg"), {"restart": 10, "tol": 1e-10}),
    "fgmres-f32": ("fgmres", ("poisson", 24, "cbpr2"),
                   {"restart": 10, "tol": 1e-10, "inner": "float32"}),
    "fgmres-x0": ("fgmres", ("poisson", 16, "cbpr2"), {"restart": 8, "tol": 1e-10, "x0": True}),
    "fgmres-max-restarts": ("fgmres", ("poisson", 16, None),
                            {"restart": 4, "tol": 1e-12, "max_restarts": 2}),
    "fgmres-zero-b": ("fgmres", ("poisson", 8, None), {"zero_b": True}),
    "fgmres-1x1": ("fgmres", ("1x1",), {"tol": 1e-12}),
    "fgmres-v-err": ("fgmres", ("poisson", 16, "cbpr2"),
                     {"restart": 10, "tol": 1e-10, "compute_v_err": True}),
    "lgmres-cbpr2": ("lgmres", ("poisson", 24, "cbpr2"), {"restart": 5, "aug": 3, "tol": 1e-10}),
    "lgmres-aug0": ("lgmres", ("poisson", 24, "cbpr2"), {"restart": 5, "aug": 0, "tol": 1e-10}),
    "lgmres-mg": ("lgmres", ("convdiff", 32, "mg"), {"restart": 6, "aug": 2, "tol": 1e-10}),
    "lgmres-plain": ("lgmres", ("convdiff", 16, None), {"restart": 8, "aug": 3, "tol": 1e-9}),
    "lgmres-f32": ("lgmres", ("poisson", 24, "cbpr2"),
                   {"restart": 5, "aug": 3, "tol": 1e-10, "inner": "float32"}),
    "lgmres-x0": ("lgmres", ("poisson", 16, "cbpr2"),
                  {"restart": 5, "aug": 2, "tol": 1e-10, "x0": True}),
    "lgmres-max-restarts": ("lgmres", ("poisson", 16, None),
                            {"restart": 4, "aug": 2, "tol": 1e-12, "max_restarts": 3}),
    "lgmres-zero-b": ("lgmres", ("poisson", 8, None), {"zero_b": True}),
    "lgmres-1x1": ("lgmres", ("1x1",), {"tol": 1e-12}),
    "lgmres-v-err": ("lgmres", ("poisson", 16, "cbpr2"),
                     {"restart": 5, "aug": 3, "tol": 1e-10, "compute_v_err": True}),
}
SOLVERS = {"sstep": (gt.sstep_gmres, tt.sstep_gmres), "fgmres": (gt.fgmres, tt.fgmres),
           "lgmres": (gt.lgmres, tt.lgmres)}


def _problem(spec, pkg):
    """(A, M, n) of one package for a problem spec."""
    kind = spec[0]
    if kind == "1x1":
        a = np.array([[3.0]])
        return (jnp.asarray(a) if pkg is gt else to_torch(a)), None, None
    if kind == "dense":
        a = np.asarray(gt.poisson_matrix(spec[1]))
        return (jnp.asarray(a) if pkg is gt else to_torch(a)), None, None
    n, precond = spec[1], spec[2]
    if kind == "poisson":
        op = pkg.poisson_operator(n)
    else:
        op = pkg.convection_diffusion_operator(n, 0.4, 0.2)
    m = None
    if precond == "cbpr2":
        m = pkg.chebyshev_preconditioner(op, 0.2, 8.2)
    elif precond == "cheb16":
        m = pkg.chebyshev_preconditioner(op, 0.005, 8.0, order=16)
    elif precond == "cg4":
        m = lambda r: pkg.cg(op, r, tol=0.0, max_iterations=4).x  # noqa: E731
    elif precond == "mg":
        m = pkg.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
    return op, m, n


def _inputs(spec, kw):
    """b (and x0) as numpy: b = A·1 (zero with zero_b), x0 seeded."""
    if spec[0] == "1x1":
        b = np.array([6.0])
    elif spec[0] == "dense":
        b = np.asarray(gt.poisson_matrix(spec[1])) @ np.ones(spec[1] ** 2)
    else:
        op, _, n = _problem(spec, gt)
        b = np.asarray(op(jnp.ones((n, n))))
    if kw.get("zero_b"):
        b = np.zeros_like(b)
    x0 = seeded(91, b.shape) if kw.get("x0") else None
    return b, x0


def _call(pkg, label, b, x0):
    solver, spec, kw = CASES[label]
    kw = {k: v for k, v in kw.items() if k not in ("x0", "zero_b", "inner")}
    fn = SOLVERS[solver][0 if pkg is gt else 1]
    op, m, _ = _problem(spec, pkg)
    inner = CASES[label][2].get("inner")
    if inner:
        kw["inner_dtype"] = jnp.float32 if pkg is gt else torch.float32
    conv = jnp.asarray if pkg is gt else to_torch
    if x0 is not None:
        kw["x0"] = conv(x0)
    return fn(op, conv(b), M=m, **kw)


@functools.lru_cache(maxsize=None)
def _jax(label):
    b, x0 = _inputs(CASES[label][1], CASES[label][2])
    return _call(gt, label, b, x0), b, x0


@pytest.mark.parametrize("label", sorted(CASES))
def test_matches_jax(label):
    rj, b, x0 = _jax(label)
    rt = _call(tt, label, b, x0)
    solver, _, kw = CASES[label]
    assert (rt.restarts, rt.iterations, rt.status) == (
        int(rj.restarts), int(rj.iterations), int(rj.status))
    assert isinstance(rt.restarts, int) and isinstance(rt.iterations, int)
    assert rt.x.dtype == torch.float64 and rt.x.shape == tuple(rj.x.shape)
    assert rel_err(rt.x, rj.x) <= (1e-6 if kw.get("inner") else 1e-9)
    hist_t, hist_j = to_np(rt.residual_history), to_np(rj.residual_history)
    assert hist_t.shape == hist_j.shape
    if solver == "sstep":
        band = 1e-1 if kw.get("inner") else 2e-2
        np.testing.assert_allclose(hist_t, hist_j, rtol=band, atol=1e-14)
        np.testing.assert_allclose(float(rt.residual), float(rj.residual), rtol=band,
                                   atol=1e-14)
    else:
        np.testing.assert_allclose(hist_t, hist_j, rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(rt.residual), float(rj.residual),
                                   rtol=1e-2 if kw.get("inner") else 1e-6, atol=1e-15)
    np.testing.assert_allclose(to_np(rt.v_err), to_np(rj.v_err), rtol=0, atol=1e-10)
    if rt.status == 0 and not kw.get("zero_b"):
        assert float(rt.residual) < kw.get("tol", 1e-8)


@pytest.mark.parametrize("label", ["sstep-cheb16", "sstep-max-restarts", "fgmres-cbpr2",
                                   "fgmres-max-restarts", "lgmres-cbpr2", "fgmres-zero-b",
                                   "fgmres-1x1"])
def test_host_syncs(label):
    """s-step: the initial residual and one a cycle. FGMRES: the initial
    residual, one a cycle, and one for each inner iteration that tested
    convergence (m − 1 in a full cycle, min(iterations, m − 1) in the
    last). LGMRES's cycles grow by the pairs kept, so it is held between
    the bounds of its shortest and longest cycles. 1×1: one."""
    rj, b, x0 = _jax(label)
    rt = _call(tt, label, b, x0)
    solver, spec, kw = CASES[label]
    if solver == "sstep":
        assert rt.host_syncs == 1 + rt.restarts
    elif spec[0] == "1x1" or rt.restarts == 0:
        assert rt.host_syncs == 1
    elif solver == "fgmres":
        m = kw["restart"]
        assert rt.host_syncs == (1 + rt.restarts + (rt.restarts - 1) * (m - 1)
                                 + min(rt.iterations, m - 1))
    else:
        lo, hi = kw["restart"], kw["restart"] + kw["aug"]
        assert (1 + rt.restarts * lo - 1 + min(rt.iterations, lo - 1) - lo + 1
                <= rt.host_syncs <= 1 + rt.restarts * hi)


def test_lgmres_aug0_is_fgmres():
    """aug = 0 is restarted FGMRES, bit for bit in the port (as in JAX)."""
    _, b, _ = _jax("lgmres-aug0")
    op, m, _ = _problem(CASES["lgmres-aug0"][1], tt)
    rl = tt.lgmres(op, to_torch(b), restart=5, aug=0, tol=1e-10, M=m)
    rf = tt.fgmres(op, to_torch(b), restart=5, tol=1e-10, M=m)
    assert (rl.restarts, rl.iterations, rl.status) == (rf.restarts, rf.iterations, rf.status)
    assert torch.equal(rl.x, rf.x)
    assert torch.equal(rl.residual_history, rf.residual_history)


def test_fgmres_nonlinear_preconditioner_beats_its_own_cycles():
    """The inner-CG M is nonlinear (a fixed step budget), which FGMRES
    tolerates: it converges, as gmres_tpu's does."""
    rj, b, x0 = _jax("fgmres-inner-cg")
    rt = _call(tt, "fgmres-inner-cg", b, x0)
    assert rt.status == int(rj.status) == 0
    op = tt.poisson_operator(16)
    r = to_torch(b) - op(rt.x)
    assert float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(to_torch(b))) < 1e-8


def test_dtensor_b_raises(tmp_path):
    """A row-sharded DTensor b, which the family refused until the
    distributed slice, now solves: on a one-rank mesh with the halo
    operator, each solver takes its plain-tensor run's counts and x to
    1e-12 (tests/test_torch_dist.py holds 2 and 4 ranks to gmres_tpu)."""
    n = 16
    b = tt.poisson_operator(n)(torch.ones((n, n), dtype=torch.float64))
    calls = {
        "sstep_gmres": lambda op, v: tt.sstep_gmres(op, v, s=4, tol=1e-8),
        "fgmres": lambda op, v: tt.fgmres(op, v, restart=10, tol=1e-9),
        "lgmres": lambda op, v: tt.lgmres(op, v, restart=8, aug=2, tol=1e-9),
        "gmres_dr": lambda op, v: tt.gmres_dr(op, v, restart=12, deflate=3, tol=1e-9),
        "idrs": lambda op, v: tt.idrs(op, v, s=2, tol=1e-9),
        "gcrodr": lambda op, v: tt.gcrodr(op, v, k=3, restart=12, tol=1e-9),
        "block_gmres": lambda op, v: tt.block_gmres(op, v, restart=8, tol=1e-9),
    }
    with one_rank_mesh(tmp_path) as mesh:
        halo = tt.halo_poisson_operator(mesh)
        for name, call in calls.items():
            v = b[None] if name == "block_gmres" else b
            plain = call(tt.poisson_operator(n), v)
            sharded = call(halo, tt.shard_grid_vector(b, mesh)[None]
                           if name == "block_gmres" else tt.shard_grid_vector(b, mesh))
            assert tt.ops.blas.is_dtensor(sharded.x), name
            assert sharded.status == plain.status == 0, name
            for key in ("iterations", "restarts"):
                assert getattr(sharded, key, 0) == getattr(plain, key, 0), (name, key)
            assert rel_err(sharded.x.full_tensor(), plain.x) < 1e-12, name


def test_sstep_history_moves_with_ulp_rounding():
    """The mechanism behind the s-step band: the packages' order-16
    Chebyshev applications differ by ~1e-15 relative (JAX's compiler
    reorders the semi-iteration's arithmetic), and the Gram system, whose
    condition is the square of the monomial basis's, turns that into a
    per-cycle residual that is determined only to ~1e-4..1e-2. The port
    against itself with M perturbed by ~1e-15 in a seeded pattern moves its
    history by more than 1e-4 relative, with the same counts and status."""
    rj, b, x0 = _jax("sstep-cheb16")
    op, m, n = _problem(CASES["sstep-cheb16"][1], tt)
    kw = {"s": 8, "tol": 1e-8}
    base = tt.sstep_gmres(op, to_torch(b), M=m, **kw)
    bump = to_torch(1.0 + 2.0 ** -49 * np.sign(seeded(5, (n, n))))
    bumped = tt.sstep_gmres(op, to_torch(b), M=lambda r: m(r) * bump, **kw)
    k = base.restarts
    assert (bumped.restarts, bumped.status) == (k, 0) == (int(rj.restarts), int(rj.status))
    h0 = to_np(base.residual_history)[:k]
    moved = np.max(np.abs(to_np(bumped.residual_history)[:k] - h0) / h0)
    to_jax = np.max(np.abs(to_np(rj.residual_history)[:k] - h0) / h0)
    assert moved > 1e-4 and to_jax < 2e-2
