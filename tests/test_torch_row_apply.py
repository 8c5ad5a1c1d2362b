"""Block applications (``ops/blas.py:row_apply``, JAX's ``jax.vmap(fn)``):
``torch.func.vmap`` over the single-vector callable on a plain block, one
call a row on a DTensor block.

* Through vmap a block gives the bits of the old loop of single-vector calls
  for every operator and multigrid cycle of the package and every sparse
  format: the kernels' vmap rules and their batched plain versions run
  each lane's own arithmetic.
* The routed entries of K1, its V-cycle forms and K2 are called on a block
  once per block application, whatever the rows (their ``block_calls``,
  which chip_smoke.py reads beside the launches).
* Those entries on a CPU block (the plain versions) against gmres_tpu's
  ``jax.vmap`` of the Pallas kernels in interpret mode (K1, K2; the jnp
  compositions that XLA fuses around the TPU kernel for K1's V-cycle
  forms), at 32², three lanes, with the tolerances of test_torch_stencil.py
  and test_torch_chebk.py.
* Gradients through a block application, by torch.autograd and by
  torch.func.grad, are the loop's.
* A DTensor block keeps the loop: two gloo ranks.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import gmres_tpu as gt
from gmres_tpu.ops import fused as jfu
from gmres_tpu.ops import stencil as jst
from gmres_tpu.precond import multigrid as jmg
import gmres_tpu_torch as tt
from gmres_tpu_torch.ops import blas, fused as tfu, sparse as tsp, stencil as tst
from tests import torch_row_apply_worker as worker
from tests.torch_parity import np_poisson, rel_err, seeded, to_np, to_torch

N = 32
RTOL = {torch.float32: 2e-6, torch.float64: 1e-14}


def _dense_poisson(n):
    eye = np.eye(n * n)
    return np.stack([np_poisson(e.reshape(n, n)).reshape(-1) for e in eye], axis=1)


def _sparse(kind):
    n = 16
    if kind == "csr":
        return tt.poisson_csr(n, device="cpu")
    if kind == "coo":
        return tsp.coo_from_dense(_dense_poisson(n), device="cpu")
    if kind == "ell":
        return tsp.csr_to_ell(tt.poisson_csr(n, device="cpu"))
    if kind == "dia":
        return tt.poisson_dia(n, device="cpu")
    if kind == "hyb":
        return tt.csr_to_hyb(tt.poisson_csr(n, device="cpu"))
    return tsp.bsr_from_dense(_dense_poisson(n), 4, device="cpu")


F64, F32, C128 = torch.float64, torch.float32, torch.complex128
# name -> (callable, one row's shape, dtype)
CASES = {
    "poisson": lambda: (tt.poisson_operator(N), (N, N), F64),
    "poisson_f32": lambda: (tt.poisson_operator(N), (N, N), F32),
    "convdiff": lambda: (tt.convection_diffusion_operator(N, 0.4, 0.2), (N, N), F64),
    "helmholtz": lambda: (tt.helmholtz_operator(N, 0.5), (N, N), F64),
    "helmholtz_damped": lambda: (tt.helmholtz_operator(N, 0.5, damping=0.1), (N, N), C128),
    "helmholtz_split": lambda: (tt.helmholtz_split_operator(N, 0.5, damping=0.1), (2, N, N),
                                F64),
    "anisotropic": lambda: (tt.anisotropic_operator(N, 0.1), (N, N), F64),
    "poisson3d": lambda: (tt.poisson3d_operator(8), (8, 8, 8), F64),
    "mg_poisson": lambda: (tt.poisson_multigrid_preconditioner(N), (N, N), F64),
    "mg_poisson_f32": lambda: (tt.poisson_multigrid_preconditioner(N), (N, N), F32),
    "mg_convdiff": lambda: (tt.convection_diffusion_multigrid_preconditioner(N, 1.0, 0.5),
                            (N, N), F64),
    "mg_convdiff_jacobi": lambda: (tt.convection_diffusion_multigrid_preconditioner(
        N, 0.4, 0.2, smoother="jacobi"), (N, N), F64),
    "mg_convdiff_rbgs": lambda: (tt.convection_diffusion_multigrid_preconditioner(
        N, 0.4, 0.2, smoother="rbgs"), (N, N), F64),
    "mg_convdiff_auto_f32": lambda: (tt.convection_diffusion_multigrid_preconditioner(
        N, 0.4, 0.2, smoother="auto", internal_dtype=F32), (N, N), F64),
    "mg_helmholtz_spd": lambda: (tt.helmholtz_shifted_laplacian_preconditioner(N, 0.5),
                                 (N, N), F64),
    "mg_csl": lambda: (tt.csl_multigrid_preconditioner(N, 0.5), (N, N), C128),
    "mg_csl_split": lambda: (tt.csl_multigrid_preconditioner(N, 0.5, layout="split"),
                             (2, N, N), F64),
    "mg_poisson3d": lambda: (tt.poisson3d_multigrid_preconditioner(16), (16, 16, 16), F64),
    "mg_anisotropic_line": lambda: (tt.anisotropic_multigrid_preconditioner(N, 0.1),
                                    (N, N), F64),
    "mg_anisotropic_point": lambda: (tt.anisotropic_multigrid_preconditioner(
        N, 0.1, smoother="point"), (N, N), F64),
    "cbpr2": lambda: (tt.chebyshev_preconditioner(tt.poisson_operator(N), 0.2, 8.2),
                      (N, N), F64),
    "chebyshev_k8": lambda: (tt.chebyshev_stencil_preconditioner(0.2, 8.2, order=8),
                             (N, N), F32),
}
for _kind in ("csr", "coo", "ell", "dia", "hyb", "bsr"):
    CASES["sparse_" + _kind] = (lambda k: lambda: (tt.sparse_operator(_sparse(k)), (256,),
                                                   F64))(_kind)


def _rows(seed, shape, dtype, s=3):
    x = seeded(seed, (s,) + shape)
    if dtype.is_complex:
        x = x + 1j * seeded(seed + 1000, (s,) + shape)
    return to_torch(x).to(dtype)


def _loop(fn, rows):
    return torch.stack([fn(rows[i]) for i in range(rows.shape[0])])


@pytest.mark.parametrize("name", sorted(CASES))
def test_row_apply_is_the_loop_bitwise(name):
    fn, shape, dtype = CASES[name]()
    rows = _rows(sorted(CASES).index(name), shape, dtype)
    out = blas.row_apply(fn, rows)
    loop = _loop(fn, rows)
    assert out.dtype == loop.dtype and out.shape == loop.shape
    assert torch.equal(out, loop), name


COUNTERS = (tst.stencil_5pt_pallas, tst.residual_restrict, tst.correct_residual,
            tfu.poly_stencil_smoother_pallas)


def _calls(fn, rows):
    before = [c.block_calls for c in COUNTERS]
    blas.row_apply(fn, rows)
    return [c.block_calls - b for c, b in zip(COUNTERS, before)]


@pytest.mark.parametrize("name,expected", [
    ("poisson", (1, 0, 0, 0)),
    ("convdiff", (1, 0, 0, 0)),
    # Two levels: the pre- and post-smoother and the coarse solve on K2,
    # one residual-restrict and one correct-residual.
    ("mg_poisson", (0, 1, 1, 3)),
    ("mg_poisson_f32", (0, 1, 1, 3)),
    ("mg_helmholtz_spd", (0, 1, 1, 3)),
    ("mg_convdiff", None),
    ("mg_convdiff_rbgs", None),
])
def test_batched_entries_once_per_block_application(name, expected):
    """One call of each routed entry on the path on a block per block
    application: the same for three rows as for one."""
    fn, shape, dtype = CASES[name]()
    three = _calls(fn, _rows(1, shape, dtype))
    assert three == _calls(fn, _rows(2, shape, dtype, s=1))
    assert sum(three) > 0
    if expected is not None:
        assert tuple(three) == expected


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_k1_matches_vmapped_pallas(dtype):
    """K1's routed entry on a CPU block (its plain version) against jax.vmap
    of the Pallas stencil in interpret mode: one coefficient set, then one
    set a lane."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    x = seeded(21, (3, N, N), npdt)
    coefs = tuple(float(c) for c in seeded(22, 5))
    ref = jax.vmap(lambda v: jst.stencil_5pt_pallas(v, jnp.asarray(coefs, dtype=npdt),
                                                    interpret=True))(jnp.asarray(x))
    out = tst.stencil_5pt_pallas(to_torch(x), coefs)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), rtol=0,
                               atol=RTOL[dtype] * np.max(np.abs(np.asarray(ref))))
    per_lane = seeded(23, (3, 5))
    ref = jax.vmap(lambda v, c: jst.stencil_5pt_pallas(v, c.astype(npdt), interpret=True))(
        jnp.asarray(x), jnp.asarray(per_lane))
    out = tst.stencil_5pt_pallas(to_torch(x), to_torch(per_lane))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), rtol=0,
                               atol=RTOL[dtype] * np.max(np.abs(np.asarray(ref))))
    for k in range(3):
        assert torch.equal(out[k], tst.stencil_5pt_general(to_torch(x[k]), *per_lane[k].tolist()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_vcycle_forms_match_vmapped_jnp(dtype):
    """K1's V-cycle forms on (lanes, …) blocks against jax.vmap of the jnp
    compositions they fuse (gmres_tpu runs these around its kernel)."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    r, e = seeded(31, (3, N, N), npdt), seeded(32, (3, N, N), npdt)
    ec = seeded(33, (3, N // 2, N // 2), npdt)
    c = (4.4, -1.3, -0.7, -1.1, -0.9)
    ref = jax.vmap(lambda a, b: jmg.restrict_sum(a - jst.stencil_5pt_general(b, *c)))(
        jnp.asarray(r), jnp.asarray(e))
    out = tst.residual_restrict(to_torch(r), to_torch(e), c)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), rtol=0,
                               atol=RTOL[dtype] * np.max(np.abs(np.asarray(ref))))

    def cr(a, b, bc):
        b2 = b + jmg.prolong_repeat(bc)
        return b2, a - jst.stencil_5pt_general(b2, *c)

    ref = jax.vmap(cr)(jnp.asarray(r), jnp.asarray(e), jnp.asarray(ec))
    out = tst.correct_residual(to_torch(r), to_torch(e), to_torch(ec), c)
    for o, rf in zip(out, ref):
        np.testing.assert_allclose(to_np(o), np.asarray(rf), rtol=0,
                                   atol=RTOL[dtype] * np.max(np.abs(np.asarray(rf))))


@pytest.mark.parametrize("order", [3, 8])
def test_batched_k2_matches_vmapped_pallas(order):
    """K2's routed entry on a CPU block against jax.vmap of the whole-grid Pallas
    smoother in interpret mode (test_torch_chebk.py's tolerance), and the
    Jacobi form on the convection–diffusion stencil."""
    r = seeded(40 + order, (3, N, N), np.float32)
    ref = jax.vmap(lambda v: jfu.chebyshev_k_poisson_pallas(v, order, 0.005, 8.0,
                                                            interpret=True))(jnp.asarray(r))
    theta, _, steps = tfu.chebyshev_k_scalars(0.005, 8.0, order)
    out = tfu.poly_stencil_smoother_pallas(to_torch(r), theta, steps)
    assert rel_err(out, ref) < 1e-6
    from gmres_tpu.models.convection_diffusion import convection_diffusion_coefs

    coefs = tuple(float(c) for c in convection_diffusion_coefs(0.4, 0.2))
    theta, steps = jfu.jacobi_k_scalars(0.7, coefs[0], order)
    ref = jax.vmap(lambda v: jfu.poly_stencil_smoother_pallas(
        v, theta, tuple(steps), coefs, interpret=True))(jnp.asarray(r))
    out = tfu.poly_stencil_smoother_pallas(to_torch(r), theta, steps, coefs)
    assert rel_err(out, ref) < 1e-6


def test_dtensor_block_keeps_the_loop(tmp_path):
    """On a block sharded along its grid rows over two gloo ranks, row_apply
    calls the Poisson operator, through a wrapper marked as taking the block
    whole (row_blocks), once, under vmap (the halo route's block form: one
    exchange for the rows), and the mesh=None V-cycle, whose distributed
    cycle takes the block whole too (row_blocks marks its wrapper), once
    likewise; it keeps the loop, one call a row with the row's DTensor and
    no call before it, for the same operator through a wrapper that is not
    marked. Each assembled result is the plain block's."""
    rows = seeded(51, (3, 16, 16))
    mp.spawn(worker.run, args=(2, str(tmp_path / "rendezvous"), str(tmp_path), rows),
             nprocs=2, join=True)
    poisson = to_np(_loop(tt.poisson_operator(16), to_torch(rows)))
    expected = {"": poisson, "loop_": poisson,
                "cycle_": to_np(_loop(tt.poisson_multigrid_preconditioner(16),
                                      to_torch(rows)))}
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        assert list(got["seen"]) == ["Tensor"]
        assert list(got["loop_seen"]) == ["DTensor"] * 3
        assert list(got["cycle_seen"]) == ["Tensor"]
        for key, want in expected.items():
            np.testing.assert_array_equal(got[f"{key}out"], want)


def test_vmap_inside_grad_takes_the_function_rules():
    """vmap composed with grad: the routed entries take their
    autograd.Functions (functorch calls the same vmap rules, one batched
    call), and the gradients are the loop's."""
    c = (4.4, -1.3, -0.7, -1.1, -0.9)
    x = _rows(61, (16, 16), F64)

    def loss(v):
        y = torch.func.vmap(lambda t: tst.stencil_5pt_pallas(t, c))(v)
        return (y * y).sum() + torch.func.vmap(
            lambda t: tst.residual_restrict(t, t * 0.5, c))(v).sum()

    before = (tst.stencil_5pt_pallas.block_calls, tst.residual_restrict.block_calls)
    g = torch.func.grad(loss)(x)
    assert (tst.stencil_5pt_pallas.block_calls - before[0],
            tst.residual_restrict.block_calls - before[1]) == (1, 1)

    def loss_loop(v):
        y = torch.stack([tst.stencil_5pt_general(v[i], *c) for i in range(v.shape[0])])
        rr = torch.stack([tst.residual_restrict_plain(v[i], v[i] * 0.5, c)
                          for i in range(v.shape[0])])
        return (y * y).sum() + rr.sum()

    torch.testing.assert_close(g, torch.func.grad(loss_loop)(x), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["poisson", "convdiff"])
def test_autograd_through_row_apply_is_the_loop(name):
    """torch.autograd through a block application of an operator on K1's
    route: vmap's rule takes the Function (autograd tracks the unwrapped
    block), one call on the block, and x's gradient is the loop's."""
    fn, shape, dtype = CASES[name]()
    w = _rows(71, shape, dtype)
    grads = []
    for apply in (blas.row_apply, _loop):
        x = _rows(72, shape, dtype).requires_grad_()
        before = tst.stencil_5pt_pallas.block_calls
        y = apply(fn, x)
        calls = tst.stencil_5pt_pallas.block_calls - before
        assert calls == (1 if apply is blas.row_apply else 0)
        (g,) = torch.autograd.grad((y * w).sum(), x)
        grads.append(g)
    assert torch.equal(*grads)
