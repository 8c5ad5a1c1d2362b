"""Helmholtz (ROADMAP item 9.3b): the model, the SPD shifted-Laplacian and
CSL cycles of the PyTorch port against ``gmres_tpu`` on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
real operator is bitwise JAX's; the complex one within 1e-14 relative (the
complex centre's product rounds differently). The cycles agree with JAX's
within 1e-14 relative in float64: gmres_tpu's CPU cycle rounds with XLA's
fused multiply-adds. MINRES on the indefinite operator follows rounding
into its count (23 steps against 25 at 32²); the counts are held within 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu_torch.models import helmholtz as th
from tests.torch_parity import one_rank_mesh, rel_err, seeded, to_np, to_torch

N = 16
KH2 = 10.0 * gt.helmholtz_lambda_min(N)
# XLA's fused multiply-adds against torch's separate roundings, through a
# cycle of a few dozen sweeps.
CYCLE_RTOL = {np.float64: 1e-14, np.float32: 1e-6}


def test_names_and_constants_match_jax():
    for name in ("helmholtz_apply", "helmholtz_operator", "helmholtz_matrix",
                 "helmholtz_lambda_min", "helmholtz_split_operator", "complex_to_split",
                 "split_to_complex", "helmholtz_shifted_laplacian_preconditioner",
                 "csl_multigrid_preconditioner"):
        assert name in tt.__all__
    from gmres_tpu.models import helmholtz as jh

    for kh2, damping in ((0.5, 0.0), (KH2, 0.3)):
        assert th.helmholtz_coefs(kh2, damping) == jh.helmholtz_coefs(kh2, damping)
    for n, kh2 in ((16, 0.0), (33, 0.2)):
        assert tt.helmholtz_lambda_min(n, kh2) == gt.helmholtz_lambda_min(n, kh2)


@pytest.mark.parametrize("damping", [0.0, 0.3])
def test_operator_and_apply_match_jax(damping):
    x = seeded(1, (N, N))
    if damping:
        x = x + 1j * seeded(2, (N, N))
    want = np.asarray(gt.helmholtz_operator(N, KH2, damping)(jnp.asarray(x)))
    got = tt.helmholtz_operator(N, KH2, damping)(to_torch(x))
    flat = tt.helmholtz_apply(to_torch(x.reshape(-1)), KH2, damping)
    if damping:  # the complex centre's product rounds differently
        assert rel_err(got, want) <= 1e-14
    else:
        np.testing.assert_array_equal(to_np(got), want)
    np.testing.assert_array_equal(to_np(flat), to_np(got).reshape(-1))


@pytest.mark.parametrize("damping", [0.0, 0.3])
def test_matrix_matches_jax_and_operator(damping):
    a = tt.helmholtz_matrix(N, KH2, damping=damping, device="cpu")
    np.testing.assert_array_equal(to_np(a), np.asarray(gt.helmholtz_matrix(N, KH2,
                                                                           damping=damping)))
    assert a.dtype == (torch.complex128 if damping else torch.float64)
    x = seeded(3, (N, N))
    y = tt.helmholtz_operator(N, KH2, damping)(to_torch(x).to(a.dtype))
    np.testing.assert_allclose(to_np(a) @ x.reshape(-1), to_np(y).reshape(-1), atol=1e-13)


def test_split_operator_matches_jax_and_the_complex_operator():
    u = seeded(4, (2, N, N))
    got = tt.helmholtz_split_operator(N, KH2, 0.3)(to_torch(u))
    np.testing.assert_array_equal(
        to_np(got), np.asarray(gt.helmholtz_split_operator(N, KH2, 0.3)(jnp.asarray(u))))
    z = tt.split_to_complex(to_torch(u))
    np.testing.assert_array_equal(to_np(tt.complex_to_split(z)), u)
    np.testing.assert_array_equal(to_np(z), np.asarray(gt.split_to_complex(jnp.asarray(u))))
    via_complex = tt.complex_to_split(tt.helmholtz_operator(N, KH2, 0.3)(z))
    assert rel_err(got, via_complex) <= 1e-14


@pytest.mark.parametrize("internal", [None, np.float32], ids=["f64", "f32-cycle"])
def test_spd_cycle_matches_jax(internal):
    n = 32
    kh2 = 10.0 * gt.helmholtz_lambda_min(n)
    r = seeded(5, (n, n))
    mj = gt.helmholtz_shifted_laplacian_preconditioner(
        n, kh2, internal_dtype=jnp.float32 if internal else None)
    mt = tt.helmholtz_shifted_laplacian_preconditioner(
        n, kh2, internal_dtype=torch.float32 if internal else None)
    assert rel_err(mt(to_torch(r)), np.asarray(mj(jnp.asarray(r)))) <= \
        CYCLE_RTOL[internal or np.float64]
    assert (mt.levels, mt.level_shifts, mt.fine_equiv_sweeps) == \
        (mj.levels, mj.level_shifts, mj.fine_equiv_sweeps)


def test_spd_cycle_is_symmetric_positive_definite():
    """Dense assembly at 16² with a real V-cycle (two levels): the cycle
    MINRES needs is SPD, as gmres_tpu's test_minres.py checks for JAX."""
    n = 16
    m = tt.helmholtz_shifted_laplacian_preconditioner(n, 0.08, levels=2)
    eye = torch.eye(n * n, dtype=torch.float64).reshape(n * n, n, n)
    mat = torch.stack([m(e).reshape(-1) for e in eye], dim=1).numpy()
    np.testing.assert_allclose(mat, mat.T, atol=1e-12 * np.abs(mat).max())
    assert np.linalg.eigvalsh(0.5 * (mat + mat.T)).min() > 0
    mj = gt.helmholtz_shifted_laplacian_preconditioner(n, 0.08, levels=2)
    cols = jax.vmap(lambda e: mj(e).reshape(-1))(jnp.eye(n * n).reshape(n * n, n, n))
    assert rel_err(mat, np.asarray(cols).T) <= 1e-14


@pytest.mark.parametrize("layout", ["complex", "split"])
def test_csl_cycle_matches_jax(layout):
    n = 32
    kh2 = 10.0 * gt.helmholtz_lambda_min(n)
    if layout == "split":
        r = seeded(6, (2, n, n))
    else:
        r = seeded(6, (n, n)) + 1j * seeded(7, (n, n))
    mj = gt.csl_multigrid_preconditioner(n, kh2, layout=layout)
    mt = tt.csl_multigrid_preconditioner(n, kh2, layout=layout)
    assert rel_err(mt(to_torch(r)), np.asarray(mj(jnp.asarray(r)))) <= 1e-14
    assert mt.levels == mj.levels and mt.fine_equiv_sweeps == mj.fine_equiv_sweeps
    assert mt.level_coefs == mj.level_coefs


def test_split_csl_cycle_is_the_complex_cycle():
    n = 32
    kh2 = 10.0 * gt.helmholtz_lambda_min(n)
    z = to_torch(seeded(8, (n, n)) + 1j * seeded(9, (n, n)))
    split = tt.csl_multigrid_preconditioner(n, kh2, layout="split")
    cplx = tt.csl_multigrid_preconditioner(n, kh2)
    assert rel_err(split(tt.complex_to_split(z)), tt.complex_to_split(cplx(z))) <= 1e-13


def test_cycles_refuse_what_they_do_not_take(tmp_path):
    """Every Helmholtz cycle takes the distributed options now: the SPD
    cycle since the distributed slice, the CSL cycle (both layouts) since
    ROADMAP item 8.3b. On a one-rank mesh each mesh= cycle is the plain
    cycle within 1e-13 (tests/test_torch_dist.py and
    tests/test_torch_dist_models.py run 2 and 4 ranks); replicate_below
    without a mesh is ignored, as in gmres_tpu. What they still refuse: a
    negative SPD shift, an unknown layout, a size the levels do not
    divide."""
    kh2 = 10.0 * gt.helmholtz_lambda_min(32)
    r = to_torch(seeded(10, (32, 32)))
    z = r + 1j * to_torch(seeded(11, (32, 32)))
    plain = tt.helmholtz_shifted_laplacian_preconditioner(32, kh2)
    with one_rank_mesh(tmp_path) as mesh:
        dm = tt.helmholtz_shifted_laplacian_preconditioner(32, kh2, mesh=mesh)
        assert rel_err(dm(tt.shard_grid_vector(r, mesh)).full_tensor(), plain(r)) <= 1e-13
        for layout, v, dim in (("complex", z, 0), ("split", tt.complex_to_split(z), 1)):
            from torch.distributed.tensor import Shard, distribute_tensor

            csl = tt.csl_multigrid_preconditioner(32, 0.1, mesh=mesh, replicate_below=32,
                                                  layout=layout)
            assert csl.replicate_from == 1
            got = csl(distribute_tensor(v, mesh, [Shard(dim)])).full_tensor()
            want = tt.csl_multigrid_preconditioner(32, 0.1, layout=layout)(v)
            assert rel_err(got, want) <= 1e-13
    ignored = tt.csl_multigrid_preconditioner(32, 0.1, replicate_below=8)
    assert rel_err(ignored(z), tt.csl_multigrid_preconditioner(32, 0.1)(z)) == 0
    with pytest.raises(ValueError, match="shift"):
        tt.helmholtz_shifted_laplacian_preconditioner(32, 0.1, shift=-1.0)
    with pytest.raises(ValueError, match="layout"):
        tt.csl_multigrid_preconditioner(32, 0.1, layout="planar")
    with pytest.raises(ValueError, match="divisible"):
        tt.helmholtz_shifted_laplacian_preconditioner(20, 0.1, levels=4)


def test_minres_with_the_spd_cycle_counts():
    """MINRES on the indefinite operator with the SPD cycle: its Lanczos
    loses orthogonality and the stopping step follows rounding (23 against
    gmres_tpu's 25 at 32²; 34 both at 1024² on the card), so the count is
    held within 2 and x to 1e-6."""
    n = 32
    kh2 = 10.0 * gt.helmholtz_lambda_min(n)
    bj = gt.helmholtz_operator(n, kh2)(jnp.ones((n, n)))
    rj = gt.minres(gt.helmholtz_operator(n, kh2), bj, tol=1e-9,
                   M=gt.helmholtz_shifted_laplacian_preconditioner(n, kh2))
    rt = tt.minres(tt.helmholtz_operator(n, kh2), to_torch(bj), tol=1e-9,
                   M=tt.helmholtz_shifted_laplacian_preconditioner(n, kh2))
    assert rt.converged and bool(rj.converged)
    assert abs(rt.iterations - int(rj.iterations)) <= 2
    np.testing.assert_allclose(to_np(rt.x), np.asarray(rj.x), atol=1e-6)
    np.testing.assert_allclose(to_np(rt.x), 1.0, atol=1e-6)


def total(res, m=30):
    return (int(res.restarts) - 1) * m + int(res.iterations)


@pytest.mark.parametrize("damping", [0.0, 0.5])
def test_csl_gmres_counts_match_jax(damping):
    """MGSR GMRES(30) with the complex CSL cycle on the complex operator:
    JAX's counts undamped; damped, the complex centre's products round
    differently and the last cycle's count moves by one (8 against 9), so
    the total is held within 2."""
    n = 32
    kh2 = 10.0 * gt.helmholtz_lambda_min(n)
    x = np.ones((n, n), dtype=np.complex128)
    bj = gt.helmholtz_operator(n, kh2, damping)(jnp.asarray(x))
    rj = gt.gmres(gt.helmholtz_operator(n, kh2, damping), bj, restart=30, tol=1e-9,
                  M=gt.csl_multigrid_preconditioner(n, kh2), variant="mgsr",
                  certify="true", compute_v_err=False)
    rt = tt.gmres(tt.helmholtz_operator(n, kh2, damping), to_torch(bj), restart=30,
                  tol=1e-9, M=tt.csl_multigrid_preconditioner(n, kh2), variant="mgsr",
                  certify="true", compute_v_err=False)
    assert rt.status == int(rj.status) == 0
    assert abs(total(rt) - total(rj)) <= (0 if damping == 0 else 2)
    np.testing.assert_allclose(to_np(rt.x), np.asarray(rj.x), atol=1e-8)


def test_float32_cycle_counts_hold_their_bands():
    """With float32 inside the cycle the counts follow the float32 sums:
    MINRES with the float32 SPD cycle is held to 15% of gmres_tpu's
    (chip_smoke.py's HELM_MINRES_BAND: 54 against 50 at 1024² on the card,
    42 against 41 here), and GMRES on the split system with float32 CSL
    cycles to one restart cycle and 2 (CSL_SPLIT_BAND: 160 against 200
    total inner here, 348 both at 512² on the card)."""
    n = 32
    kh2 = 10.0 * gt.helmholtz_lambda_min(n)
    bj = gt.helmholtz_operator(n, kh2)(jnp.ones((n, n)))
    rj = gt.minres(gt.helmholtz_operator(n, kh2), bj, tol=1e-9,
                   M=gt.helmholtz_shifted_laplacian_preconditioner(
                       n, kh2, internal_dtype=jnp.float32))
    rt = tt.minres(tt.helmholtz_operator(n, kh2), to_torch(bj), tol=1e-9,
                   M=tt.helmholtz_shifted_laplacian_preconditioner(
                       n, kh2, internal_dtype=torch.float32))
    assert rt.converged and abs(rt.iterations - int(rj.iterations)) <= \
        max(2, 0.15 * int(rj.iterations))
    m = 40
    u = np.stack([np.ones((n, n)), np.zeros((n, n))])
    bs = gt.helmholtz_split_operator(n, kh2)(jnp.asarray(u))
    kw = dict(restart=m, tol=1e-9, variant="mgsr", certify="true", compute_v_err=False)
    rj = gt.gmres(gt.helmholtz_split_operator(n, kh2), bs,
                  M=gt.csl_multigrid_preconditioner(n, kh2, layout="split"),
                  inner_dtype=jnp.float32, **kw)
    rt = tt.gmres(tt.helmholtz_split_operator(n, kh2), to_torch(bs),
                  M=tt.csl_multigrid_preconditioner(n, kh2, layout="split"),
                  inner_dtype=torch.float32, **kw)
    assert rt.status == int(rj.status) == 0
    assert abs(total(rt, m) - total(rj, m)) <= m + 2
