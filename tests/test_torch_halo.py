"""The distributed explicit-halo path of the PyTorch port against
gmres_tpu.parallel, at 1, 2 and 4 ranks.

Each world size runs as that many gloo processes on the CPU
(tests/torch_halo_worker.py), which rendezvous on a file under the
test's temporary directory, so concurrent test workers never share a
port. Every rank drives the port on row-sharded DTensors and writes its
local blocks; the blocks are assembled here and held against JAX's
shard_map halo path on the 8-virtual-device CPU mesh (conftest.py), with
the same numpy-seeded inputs. Tolerances: the operators and
preconditioners to 1e-13 relative (a shard boundary moves where a halo
row is added, which may change a last bit); the solvers' counts equal and
their solutions to 1e-9 relative (solves to tol 1e-9/1e-10 from the same
operators); residual histories to 1e-9 relative above a 1e-15 floor, and
CG's certified residual above the 1e-13 floor of its own rounding.

The same processes drive the RDMA route (``ops/stencil_rdma.py``), held
against JAX's RDMA route in interpret mode on a mesh of as many devices as
ranks (the ``jax_rdma`` fixture), with float32 tolerances stated per test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import gmres_tpu as gt
from gmres_tpu.models.convection_diffusion import convection_diffusion_coefs
from gmres_tpu.parallel.halo import (
    halo_chebyshev_preconditioner,
    halo_poisson_operator,
    halo_stencil_operator,
    rdma_chebyshev_preconditioner,
    rdma_stencil_operator,
)
from gmres_tpu.parallel.mesh import shard_grid_vector, solver_mesh
from tests import torch_halo_worker
from tests.torch_parity import np_poisson, rel_err, seeded

N_OP = 32      # operator and preconditioner grid, and CG's
N_GMRES = 24   # GMRES grid (tests/test_halo.py's), also on the RDMA route
# CG on the RDMA route: JAX's interpret mode simulates each remote copy on
# the host (~0.25 s an application on 4 devices), so its grid is small.
N_RDMA_CG = 16
RESTART = 12
ORTHOS = ("cgs2", "mgs2")


@pytest.fixture(scope="module")
def cases():
    return {
        "x": seeded(900, (N_OP, N_OP)),
        "coefs": convection_diffusion_coefs(0.4, 0.2),
        "coefs_asym": convection_diffusion_coefs(0.7, 0.3),
        "b_cg": np_poisson(np.ones((N_OP, N_OP))),
        "b_gmres": np_poisson(np.ones((N_GMRES, N_GMRES))),
        "b_rdma_gmres": np_poisson(np.ones((N_GMRES, N_GMRES))).astype(np.float32),
        "b_rdma_cg": np_poisson(np.ones((N_RDMA_CG, N_RDMA_CG))).astype(np.float32),
        "restart": RESTART,
    }


@pytest.fixture(scope="module")
def jax_ref(cases):
    """JAX's halo path on the 8-device mesh: the same cases as the worker."""
    mesh = solver_mesh(8)

    def shard(a):
        return shard_grid_vector(jnp.asarray(a), mesh)

    x = shard(cases["x"])
    ref = {
        "y_poisson": jax.jit(halo_poisson_operator(mesh))(x),
        "y_general": jax.jit(halo_stencil_operator(mesh, cases["coefs"]))(x),
    }
    for order in (2, 4):
        m_inv = halo_chebyshev_preconditioner(mesh, 0.2, 8.2, order=order)
        ref[f"z_order{order}"] = jax.jit(m_inv)(x)
    op = halo_poisson_operator(mesh)
    m_inv = halo_chebyshev_preconditioner(mesh, 0.2, 8.2)
    res = jax.jit(lambda v: gt.cg(op, v, tol=1e-9, max_iterations=2000,
                                  M=m_inv))(shard(cases["b_cg"]))
    ref["cg"] = res
    ref["gmres_householder"] = jax.jit(
        lambda v: gt.gmres(op, v, restart=RESTART, tol=1e-10, M=m_inv,
                           max_restarts=100, variant="householder")
    )(shard(cases["b_gmres"]))
    for ortho in ORTHOS:
        ref[f"gmres_{ortho}"] = jax.jit(
            lambda v, o=ortho: gt.gmres(op, v, restart=RESTART, tol=1e-10,
                                        M=m_inv, max_restarts=100,
                                        variant="mgsr", orthogonalization=o)
        )(shard(cases["b_gmres"]))
    return ref


@pytest.fixture(scope="module", params=(1, 2, 4), ids=lambda w: f"world{w}")
def port(request, cases, tmp_path_factory):
    """The worker's outputs at one world size: row blocks concatenated in
    rank order, per-rank scalars checked equal on every rank."""
    world = request.param
    out_dir = tmp_path_factory.mktemp(f"halo_world{world}")
    mp.spawn(torch_halo_worker.run,
             args=(world, os.path.join(out_dir, "rendezvous"), str(out_dir),
                   cases),
             nprocs=world)
    ranks = [np.load(os.path.join(out_dir, f"rank{r}.npz")) for r in range(world)]
    out = {"world": world}
    for key in ranks[0].files:
        vals = [z[key] for z in ranks]
        if vals[0].ndim == 2:
            out[key] = np.concatenate(vals, axis=0)
        else:
            for v in vals[1:]:
                np.testing.assert_array_equal(v, vals[0])
            out[key] = vals[0]
    return out


def test_halo_operators_match_jax(port, jax_ref, cases):
    """The Laplacian and a convection–diffusion stencil (general
    coefficients, tests/test_halo.py's) over the sharded grid, on the mesh
    init_multihost made over every rank."""
    assert tuple(port["mesh_shape"]) == (port["world"],)
    for key in ("y_poisson", "y_general"):
        assert port[key].shape == (N_OP, N_OP)
        assert rel_err(port[key], jax_ref[key]) < 1e-13, key
    # and against an independent numpy Laplacian
    assert rel_err(port["y_poisson"], np_poisson(cases["x"])) < 1e-13
    # Each rank's plain block through the operator gives its sharded result.
    np.testing.assert_array_equal(port["y_poisson_plain_block"], port["y_poisson"])


def test_halo_rows_absent_at_the_edges(port, cases):
    """halo_exchange keeps JAX's contract (two rows, zeros at the physical
    boundary); the operators' rows are absent there (the kernels read a
    null row as zero) and are the neighbours' rows elsewhere."""
    world, x = port["world"], cases["x"]
    rows = N_OP // world
    for r in range(world):
        top = x[r * rows - 1] if r > 0 else np.zeros(N_OP)
        bottom = x[(r + 1) * rows] if r < world - 1 else np.zeros(N_OP)
        np.testing.assert_array_equal(port["halo_exchange_rows"][r],
                                      np.concatenate([top, bottom]))
        got_top, got_bottom = np.split(port["halo_rows"][r], 2)
        for got, want, absent in ((got_top, top, r == 0),
                                  (got_bottom, bottom, r == world - 1)):
            if absent:
                assert np.isnan(got).all()
            else:
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", [2, 4])
def test_halo_chebyshev_preconditioner_matches_jax(port, jax_ref, order):
    key = f"z_order{order}"
    assert rel_err(port[key], jax_ref[key]) < 1e-13


def test_cg_on_halo_operator_matches_jax(port, jax_ref):
    ref = jax_ref["cg"]
    iterations, status = port["cg_counts"]
    assert status == int(ref.status) == 0
    assert iterations == int(ref.iterations)
    assert rel_err(port["cg_x"], ref.x) < 1e-9
    # The certified ‖b − A x‖ (~4e-10) carries the rounding of a float64
    # stencil over a unit-sized solution: ~1e-15 absolute.
    np.testing.assert_allclose(port["cg_residual"], float(ref.residual),
                               rtol=1e-6, atol=1e-13)


@pytest.mark.parametrize("ortho", ORTHOS)
def test_mgsr_gmres_on_halo_operator_matches_jax(port, jax_ref, ortho):
    ref = jax_ref[f"gmres_{ortho}"]
    iterations, restarts, status = port[f"gmres_{ortho}_counts"]
    assert status == int(ref.status) == 0
    assert (iterations, restarts) == (int(ref.iterations), int(ref.restarts))
    assert bool(port[f"gmres_{ortho}_x_is_sharded"])
    assert rel_err(port[f"gmres_{ortho}_x"], ref.x) < 1e-9
    np.testing.assert_allclose(port[f"gmres_{ortho}_history"],
                               np.asarray(ref.residual_history),
                               rtol=1e-9, atol=1e-15)
    # v_err sits at the rounding floor of a float64 basis (~1e-15).
    np.testing.assert_allclose(port[f"gmres_{ortho}_v_err"],
                               np.asarray(ref.v_err), rtol=0, atol=1e-14)


@pytest.fixture(scope="module")
def jax_rdma(port, cases):
    """JAX's RDMA route (Pallas interpret mode, simulated remote copies) on a
    mesh of as many devices as the port has ranks: a shard boundary moves
    where a halo row is added, so only equal partitions compare closely."""
    mesh = solver_mesh(port["world"])

    def shard(a):
        return shard_grid_vector(jnp.asarray(a), mesh)

    x32 = shard(cases["x"].astype(np.float32))
    op = rdma_stencil_operator(mesh, interpret=True)
    m_inv = rdma_chebyshev_preconditioner(mesh, 0.2, 8.2, interpret=True)
    return {
        "rdma_poisson": op(x32),
        "rdma_asym": rdma_stencil_operator(mesh, cases["coefs_asym"],
                                           interpret=True)(x32),
        "rdma_cbpr2": m_inv(x32),
        "gmres": jax.jit(lambda v: gt.gmres(
            op, v, restart=30, tol=1e-5, M=m_inv, max_restarts=10,
            variant="mgsr", compute_v_err=False))(shard(cases["b_rdma_gmres"])),
        "cg": jax.jit(lambda v: gt.cg(op, v, tol=1e-4, max_iterations=500))(
            shard(cases["b_rdma_cg"])),
    }


@pytest.mark.parametrize("key", ["rdma_poisson", "rdma_asym", "rdma_cbpr2"])
def test_rdma_operators_match_jax(port, jax_rdma, cases, key):
    """The RDMA Laplacian, the asymmetric convection–diffusion stencil (top
    halo weighted by the south coefficient: tests/test_rdma.py's
    swapped-halo check) and the RDMA cbpr2, in float32. Tolerance: a few
    float32 ulps of max|y|, since XLA:CPU may contract the interpret-mode
    kernel's products and sums into fused multiply-adds."""
    assert port[key].dtype == np.float32 and port[key].shape == (N_OP, N_OP)
    assert rel_err(port[key], jax_rdma[key]) < 1e-6
    if key == "rdma_poisson":
        assert rel_err(port["rdma_poisson_f64"], np_poisson(cases["x"])) < 1e-14


def test_rdma_rows_absent_at_the_edges(port, cases):
    """The RDMA route receives a row only from a neighbour that exists: none
    on one rank, one on each end rank of 2 or 4, two in between; each is
    the neighbour's boundary row."""
    world, x = port["world"], cases["x"].astype(np.float32)
    rows = N_OP // world
    for r in range(world):
        got_top, got_bottom = np.split(port["rdma_rows"][r], 2)
        if r == 0:
            assert np.isnan(got_top).all()
        else:
            np.testing.assert_array_equal(got_top, x[r * rows - 1])
        if r == world - 1:
            assert np.isnan(got_bottom).all()
        else:
            np.testing.assert_array_equal(got_bottom, x[(r + 1) * rows])


def test_rdma_public_entry_and_float64(port, cases):
    """stencil_5pt_rdma, which rounds its coefficients and finds its
    neighbours on every call, gives the operator's bits; the RDMA cbpr2 on
    a float64 block (its coefficients rounded for float64 when first met)
    is numpy's cbpr2 to float64 rounding."""
    np.testing.assert_array_equal(port["rdma_public_asym"], port["rdma_asym"])
    x = cases["x"]
    lo, hi = 0.2, 8.2
    c, d = (hi - lo) / 2.0, (hi + lo) / 2.0
    alpha = 1.0 / (d - (c / d / 2.0) ** 2)
    want = x / d + alpha * (x - np_poisson(x) / d)
    assert port["rdma_cbpr2_f64"].dtype == np.float64
    assert rel_err(port["rdma_cbpr2_f64"], want) < 1e-14


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("missing", ["both", "top", "bottom"])
def test_rdma_edges_plain_without_rows_equals_zero_rows(dtype, missing):
    """A side with no neighbour gets no halo row (None) where the TPU kernel
    adds a zero row: the same values. The one difference is the sign of an
    exact zero, pinned here: where y is −0.0 and b·cs > 0 (cbpr2's
    (1/d + α, −α/d) with cs = −1), −0.0 + (b·cs)·0 is +0.0, and without the
    row y stays −0.0; the two compare equal (torch.equal, and
    assert_close with rtol=0, atol=0)."""
    from gmres_tpu_torch.ops import fused as tfu
    from gmres_tpu_torch.ops import stencil_rdma as trd

    d, alpha = tfu.chebyshev_ref_scalars(0.2, 8.2)
    c = trd._coefs7((4.0, -1.0, -1.0, -1.0, -1.0, 1.0 / d + alpha, -alpha / d), dtype)
    x = torch.as_tensor(seeded(901, (6, 9))).to(dtype)
    rand = torch.as_tensor(seeded(902, (2, 9))).to(dtype)
    zero = torch.zeros((1, 9), dtype=dtype)
    top = None if missing in ("both", "top") else rand[:1]
    bottom = None if missing in ("both", "bottom") else rand[1:]
    y = trd.rdma_interior_plain(x, c)
    y[0, 3] = y[-1, 4] = -0.0
    with_zero = trd.rdma_edges_plain(
        y.clone(), zero if top is None else top, zero if bottom is None else bottom, c)
    without = trd.rdma_edges_plain(y.clone(), top, bottom, c)
    torch.testing.assert_close(without, with_zero, rtol=0, atol=0)
    assert torch.equal(without, with_zero)
    assert all(v > 0 for v in trd._edge_scales(c, dtype))
    if top is None:
        assert torch.signbit(without[0, 3]) and not torch.signbit(with_zero[0, 3])
    if bottom is None:
        assert torch.signbit(without[-1, 4]) and not torch.signbit(with_zero[-1, 4])
    # The given rows are added as before, and the interior rows untouched.
    torch.testing.assert_close(without[1:-1], y[1:-1], rtol=0, atol=0)


def test_rdma_gmres_matches_jax(port, jax_rdma):
    """f32 MGSR GMRES with A and M on the RDMA route: counts within 2 of
    JAX's, and both solutions at the manufactured x = 1 to f32 accuracy
    (two float32 solves to tol 1e-5 agree to 1e-4 relative)."""
    ref = jax_rdma["gmres"]
    iterations, restarts, status = port["rdma_gmres_counts"]
    assert status == int(ref.status) == 0
    assert abs((restarts - 1) * 30 + iterations
               - (int(ref.restarts) - 1) * 30 - int(ref.iterations)) <= 2
    np.testing.assert_allclose(port["rdma_gmres_x"], 1.0, atol=1e-3)
    assert rel_err(port["rdma_gmres_x"], ref.x) < 1e-4


def test_rdma_cg_matches_jax(port, jax_rdma):
    """CG on the RDMA operator (dryrun_multichip's stanza), float32."""
    ref = jax_rdma["cg"]
    iterations, status = port["rdma_cg_counts"]
    assert status == int(ref.status) == 0
    assert abs(iterations - int(ref.iterations)) <= 2
    np.testing.assert_allclose(port["rdma_cg_x"], 1.0, atol=1e-3)
    assert rel_err(port["rdma_cg_x"], ref.x) < 1e-4


def test_householder_refuses_sharded_rhs(port, jax_ref):
    """A DTensor b under variant='householder', which the port refused
    until the distributed slice, now solves: GMRES(12) with cbpr2 on the
    halo route takes JAX's iterations and restarts, x to 1e-9 relative
    (the MGSR tolerances above)."""
    ref = jax_ref["gmres_householder"]
    iterations, restarts, status = port["gmres_householder_counts"]
    assert status == int(ref.status) == 0
    assert (iterations, restarts) == (int(ref.iterations), int(ref.restarts))
    assert rel_err(port["gmres_householder_x"], ref.x) < 1e-9


def test_mesh_errors_match_jax(port):
    """solver_mesh asked for more ranks than exist, and shard_grid_vector of
    31 rows over 2 or 4 ranks, raise ValueError with gmres_tpu's messages."""
    world = port["world"]
    with pytest.raises(ValueError) as jax_mesh:
        solver_mesh(world + 1, devices=jax.devices()[:world])
    assert str(port["mesh_error"]) == str(jax_mesh.value)
    if world == 1:
        assert str(port["shard_error"]) == ""
    else:
        with pytest.raises(ValueError) as jax_shard:
            shard_grid_vector(jnp.zeros((31, 31)), solver_mesh(world))
        assert str(port["shard_error"]) == str(jax_shard.value)
