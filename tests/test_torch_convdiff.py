"""The convection-diffusion model and its multigrid cycle in the PyTorch port
against gmres_tpu, on the CPU.

Tolerances: the coefficients, ``convection_diffusion_apply``, the operator,
the dense matrix and the eigenvalues are bitwise JAX's. The cycle's static
attributes are JAX's with JAX's Arnoldi probe patched in (the port's own
probe is a torch.Generator stream that cannot reproduce PRNGKey(0)): the
level schemes and smoothers equal, ω and the ellipse intervals within 1e-12
relative (the Arnoldi reductions sum in another order). The cycle's output
against JAX run op by op (``disable_jit``): float64 bitwise with Jacobi and
red-black smoothing, within 1e-12 relative with ellipse-Chebyshev (its
interval carries the Arnoldi difference); float32 against the jitted JAX
cycle within 1e-5 relative (XLA fuses multiply-adds). The transposed cycle
is the dense transpose of the untransposed one within 1e-13. With the
port's own probe, BiCGSTAB with the cycle takes JAX's iterations within 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
from gmres_tpu.models import convection_diffusion as jcd
from gmres_tpu.precond import multigrid as jmg
import gmres_tpu_torch as tt
from gmres_tpu_torch.models import convection_diffusion as tcd
from gmres_tpu_torch.precond import multigrid as tmg
from tests.torch_parity import one_rank_mesh, rel_err, seeded, to_np, to_torch

GAMMAS = [(0.4, 0.2), (2.0, 1.0)]
SMOOTHERS = ["jacobi", "chebyshev", "auto", "rbgs"]


def _jax_probe(m):
    """gmres_tpu's Arnoldi probe (multigrid.py:_level_ritz) as a tensor."""
    return torch.as_tensor(np.array(jax.random.normal(
        jax.random.PRNGKey(0), (m, m), dtype=jnp.float64)))


@pytest.fixture
def jax_probe(monkeypatch):
    monkeypatch.setattr(tmg, "_ritz_probe", _jax_probe)


def _both(n, **kw):
    """(JAX cycle, port cycle) with the same arguments; (None, None) where
    JAX refuses them, after checking that the port refuses them too."""
    try:
        mj = jmg.convection_diffusion_multigrid_preconditioner(n, **kw)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)[:20]):
            tmg.convection_diffusion_multigrid_preconditioner(n, **kw)
        return None, None
    return mj, tmg.convection_diffusion_multigrid_preconditioner(n, **kw)


def _same_attributes(mj, mt):
    assert mt.levels == mj.levels
    assert mt.level_schemes == mj.level_schemes
    assert mt.smoothers == mj.smoothers
    np.testing.assert_allclose(mt.omegas, mj.omegas, rtol=1e-12, atol=0)
    for iv_t, iv_j in zip(mt.cheb_intervals + [mt.coarse_interval],
                          mj.cheb_intervals + [mj.coarse_interval]):
        assert (iv_t is None) == (iv_j is None)
        if iv_j is not None:
            np.testing.assert_allclose(iv_t, iv_j, rtol=1e-12, atol=0)


@pytest.mark.parametrize("g", [(0.4, 0.2), (2.0, 1.0), (-0.7, 1.3), (0.0, 0.0), (1e-3, -5.0)])
def test_coefficients_bitwise(g):
    assert tcd.convection_diffusion_coefs(*g) == jcd.convection_diffusion_coefs(*g)
    assert (tcd.convection_diffusion_coefs_upwind(*g)
            == jcd.convection_diffusion_coefs_upwind(*g))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("flat", [False, True])
def test_apply_and_operator_bitwise(dtype, flat):
    n = 24
    x = seeded(900, (n * n,) if flat else (n, n), dtype)
    y_j = np.asarray(gt.convection_diffusion_apply(jnp.asarray(x), 0.7, -0.3))
    y_t = tt.convection_diffusion_apply(to_torch(x), 0.7, -0.3)
    assert y_t.dtype == to_torch(x).dtype
    np.testing.assert_array_equal(to_np(y_t), y_j)
    if not flat:
        op_j = gt.convection_diffusion_operator(n, 0.7, -0.3)
        op_t = tt.convection_diffusion_operator(n, 0.7, -0.3)
        np.testing.assert_array_equal(to_np(op_t(to_torch(x))), np.asarray(op_j(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dense_matrix_and_eigenvalues(dtype):
    n = 6
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    a_t = tcd.convection_diffusion_matrix(n, 0.4, 0.2, dtype=dtype, device="cpu")
    a_j = np.asarray(jcd.convection_diffusion_matrix(n, 0.4, 0.2, dtype=jdt))
    assert a_t.dtype == dtype
    np.testing.assert_array_equal(a_t.numpy(), a_j)
    # The matrix is the operator on the C-order flattening.
    x = seeded(901, (n, n))
    np.testing.assert_allclose(
        (tcd.convection_diffusion_matrix(n, device="cpu") @ to_torch(x).reshape(-1)).numpy(),
        to_np(tt.convection_diffusion_operator(n)(to_torch(x))).reshape(-1), rtol=1e-14)
    for g in ((0.4, 0.2), (2.0, 1.0)):
        np.testing.assert_array_equal(tcd.convection_diffusion_eigenvalues(n, *g),
                                      jcd.convection_diffusion_eigenvalues(n, *g))


def test_dense_matrix_defaults_to_the_card(monkeypatch):
    """Without device= the matrix is built on the card; with no card that
    raises, as poisson_matrix does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        tcd.convection_diffusion_matrix(4)


@pytest.mark.parametrize("smoother", SMOOTHERS)
@pytest.mark.parametrize("g", GAMMAS)
@pytest.mark.parametrize("n", [32, 64, 128])
def test_cycle_matches_jax(n, g, smoother, jax_probe):
    mj, mt = _both(n, gamma_x=g[0], gamma_y=g[1], smoother=smoother)
    if mj is None:
        return
    _same_attributes(mj, mt)
    r = seeded(910 + n, (n, n))
    with jax.disable_jit():
        zj = mj(jnp.asarray(r))
    z = mt(to_torch(r))
    assert z.dtype == torch.float64 and tuple(z.shape) == (n, n)
    if "chebyshev" in mt.smoothers:
        assert rel_err(z, zj) <= 1e-12
    else:
        np.testing.assert_array_equal(to_np(z), np.asarray(zj))
    r32 = r.astype(np.float32)
    z32 = mt(to_torch(r32))
    assert z32.dtype == torch.float32
    assert rel_err(z32, mj(jnp.asarray(r32))) <= 1e-5


OPTIONS = {
    "shift": dict(shift=0.3),
    "transpose": dict(transpose=True, pre_smooth=2, post_smooth=3),
    "transpose-rbgs": dict(transpose=True, smoother="rbgs", pre_smooth=1, post_smooth=2),
    "internal-f32": dict(internal_dtype="float32"),
    "max-levels-2": dict(max_levels=2),
    "max-levels-1": dict(max_levels=1, coarse_iters=8),
    "omega-auto": dict(omega="auto"),
    "omega-auto-rbgs": dict(omega="auto", smoother="rbgs", gamma_x=2.0, gamma_y=1.0),
    "central-only": dict(central_gamma_max=100.0, gamma_x=2.0, gamma_y=1.0,
                         smoother="auto"),
    "upwind-everywhere": dict(central_gamma_max=0.1, smoother="auto"),
    "omega": dict(omega=0.55, pre_smooth=1, post_smooth=4, coarse_iters=20),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_cycle_options_match_jax(option, jax_probe):
    kw = dict(OPTIONS[option])
    n = 64
    if "internal_dtype" in kw:
        kw_j = dict(kw, internal_dtype=jnp.float32)
        kw_t = dict(kw, internal_dtype=torch.float32)
        mj = jmg.convection_diffusion_multigrid_preconditioner(n, **kw_j)
        mt = tmg.convection_diffusion_multigrid_preconditioner(n, **kw_t)
    else:
        mj = jmg.convection_diffusion_multigrid_preconditioner(n, **kw)
        mt = tmg.convection_diffusion_multigrid_preconditioner(n, **kw)
    _same_attributes(mj, mt)
    r = seeded(920, (n, n))
    if "internal_dtype" in kw:
        z = mt(to_torch(r))
        assert z.dtype == torch.float64
        assert rel_err(z, mj(jnp.asarray(r))) <= 1e-5
        return
    with jax.disable_jit():
        zj = mj(jnp.asarray(r))
    assert rel_err(mt(to_torch(r)), zj) <= 1e-12


def _dense(m_inv, n):
    cols = []
    for k in range(n * n):
        e = torch.zeros(n * n, dtype=torch.float64)
        e[k] = 1.0
        cols.append(m_inv(e.reshape(n, n)).reshape(-1))
    return torch.stack(cols, dim=1).numpy()


@pytest.mark.parametrize("smoother", ["jacobi", "rbgs"])
@pytest.mark.parametrize("n", [16, 32])
def test_transposed_cycle_is_the_dense_transpose(n, smoother):
    """The port's transpose=True cycle is the exact transpose of its own
    untransposed cycle (W↔E, S↔N, pre/post swapped, red-black flipped), as
    JAX's test_multigrid.py pins for gmres_tpu. (The ellipse-Chebyshev
    intervals come from Arnoldi on each operator, so with them the
    transposed cycle is only near the transpose, in JAX as in the port.)"""
    kw = dict(gamma_x=0.8, gamma_y=0.4, pre_smooth=2, post_smooth=3,
              coarse_iters=16, smoother=smoother)
    md = _dense(tmg.convection_diffusion_multigrid_preconditioner(n, **kw), n)
    mtd = _dense(tmg.convection_diffusion_multigrid_preconditioner(
        n, transpose=True, **kw), n)
    np.testing.assert_allclose(mtd, md.T, atol=1e-13)
    assert np.abs(md - md.T).max() > 1e-6  # genuinely nonsymmetric


def test_refusals(tmp_path):
    """The refusals that stay; the distributed options, refused until the
    distributed slice: ``replicate_below`` without a mesh is ignored (JAX's
    rule), and the mesh= cycle on a one-rank mesh is the plain cycle within
    1e-13 for each smoother (tests/test_torch_dist.py runs 2 and 4 ranks)."""
    r = to_torch(seeded(705, (64, 64)))
    for smoother in SMOOTHERS[1:]:
        plain = tt.convection_diffusion_multigrid_preconditioner(64, smoother=smoother)
        torch.testing.assert_close(tt.convection_diffusion_multigrid_preconditioner(
            64, smoother=smoother, replicate_below=8)(r), plain(r), rtol=0, atol=0)
        with one_rank_mesh(tmp_path / smoother) as mesh:
            dm = tt.convection_diffusion_multigrid_preconditioner(
                64, smoother=smoother, mesh=mesh, replicate_below=32)
            assert dm.replicate_from == 2
            z = dm(tt.shard_grid_vector(r, mesh))
            assert rel_err(z.full_tensor(), plain(r)) <= 1e-13
    with pytest.raises(ValueError, match="unknown smoother"):
        tt.convection_diffusion_multigrid_preconditioner(64, smoother="sor")
    # Every central level's band is taller than wide at γ = (2, 1): JAX's
    # test_multigrid.py pins the refusal.
    with pytest.raises(ValueError, match="infeasible"):
        tt.convection_diffusion_multigrid_preconditioner(
            64, 2.0, 1.0, central_gamma_max=100.0, smoother="chebyshev")


def test_cpu_jacobi_is_jax_loop_not_k2_form():
    """On a CPU tensor the Jacobi smoother is JAX's jnp loop (e = step·r,
    e += step·(r − A e)); K2's d-recurrence (r/θ, then 0·d + b·(…)) is the
    same polynomial and differs only in its last bits."""
    from gmres_tpu_torch.ops.fused import jacobi_k_scalars, poly_stencil_smoother_plain

    n = 16
    mt = tmg.convection_diffusion_multigrid_preconditioner(n, max_levels=1, coarse_iters=5)
    assert mt.levels == 1 and mt.smoothers == ["jacobi"]
    r = to_torch(seeded(930, (n, n)))
    c = tcd.convection_diffusion_coefs(0.4, 0.2)
    step = 0.7 / c[0]
    e = step * r
    for _ in range(4):
        e = e + step * (r - tt.convection_diffusion_apply(e))
    z = mt(r)
    np.testing.assert_array_equal(z.numpy(), e.numpy())
    theta, steps = jacobi_k_scalars(0.7, c[0], 5)
    assert rel_err(poly_stencil_smoother_plain(r, theta, steps, c), z) <= 1e-14


@pytest.mark.parametrize("smoother", ["jacobi", "auto", "rbgs"])
def test_bicgstab_with_own_probe_matches_jax_count(smoother):
    """The port's own probe (not JAX's): the cycle's ω and intervals move a
    little, and preconditioned BiCGSTAB takes JAX's iterations within 2."""
    n = 64
    b = np.asarray(gt.convection_diffusion_operator(n)(jnp.ones((n, n))))
    mj = gt.convection_diffusion_multigrid_preconditioner(n, smoother=smoother, omega="auto")
    mt = tt.convection_diffusion_multigrid_preconditioner(n, smoother=smoother, omega="auto")
    assert mt.smoothers == mj.smoothers
    rj = gt.bicgstab(gt.convection_diffusion_operator(n), jnp.asarray(b), M=mj)
    rt = tt.bicgstab(tt.convection_diffusion_operator(n), to_torch(b), M=mt)
    assert rt.status == int(rj.status) == 0
    assert abs(rt.iterations - int(rj.iterations)) <= 2
    assert rel_err(rt.x, np.ones((n, n))) <= 1e-6


def test_mixed_gmres_cycles_follow_the_float32_sums(monkeypatch):
    """Mixed GMRES (float32 Householder cycles, certified on the float64 true
    residual) with the cycle at 512², b = A·1: gmres_tpu needs 3 restart
    cycles and the port 2. The inner estimates agree; what differs is the
    float32 accuracy of each cycle's update, set by the reflector norms (the
    cycle's float32 inner products and tail sums over n = 512²), which
    XLA:CPU sums less accurately than PyTorch (pairwise) or cuBLAS. With
    gmres_tpu's float32 sums accumulated in float64, gmres_tpu also needs 2
    cycles. So mixed GMRES's count is held to gmres_tpu's within one restart
    cycle (chip_smoke.py's CONVDIFF_GMRES_BAND)."""
    import types

    import gmres_tpu.solvers.gmres as jg

    n = 512
    opj = gt.convection_diffusion_operator(n)
    b = opj(jnp.ones((n, n)))
    mj = gt.convection_diffusion_multigrid_preconditioner(n)

    def solve_jax():
        return jax.jit(lambda bb: gt.gmres(
            opj, bb, restart=30, tol=1e-9, M=mj, certify="true", compute_v_err=False,
            inner_dtype=jnp.float32, max_restarts=333))(b)

    as_is = solve_jax()
    vdot, jsum = jg.tree_vdot, jnp.sum
    monkeypatch.setattr(jg, "tree_vdot", lambda a, c: vdot(
        a.astype(jnp.float64), c.astype(jnp.float64)).astype(a.dtype))
    wide = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    wide.sum = lambda x, *a, **k: jsum(x.astype(jnp.float64), *a, **k).astype(x.dtype)
    monkeypatch.setattr(jg, "jnp", wide)
    accurate = solve_jax()
    rt = tt.gmres(tt.convection_diffusion_operator(n), to_torch(np.asarray(b)), restart=30,
                  tol=1e-9, M=tt.convection_diffusion_multigrid_preconditioner(n),
                  certify="true", compute_v_err=False, inner_dtype=torch.float32,
                  max_restarts=333)
    assert int(as_is.status) == int(accurate.status) == rt.status == 0
    assert (int(as_is.restarts), int(accurate.restarts), rt.restarts) == (3, 2, 2)
