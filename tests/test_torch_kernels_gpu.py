"""Kernels K1–K8 of the PyTorch port on the card, against their plain
PyTorch versions, and the main paths' use of them.

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor gmres_tpu, so it also runs on a machine without
JAX; there, skip the JAX-configuring conftest:

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import gmres_tpu_torch as tt
from gmres_tpu_torch.ops import dd as tdd
from gmres_tpu_torch.ops import fused as tfu
from gmres_tpu_torch.ops import sparse as tsp
from gmres_tpu_torch.ops import stencil as tst
from gmres_tpu_torch.ops import stencil_rdma as trd
from tests.torch_parity import cuda_device, np_poisson, rel_err, seeded, to_torch  # noqa: F401

pytestmark = pytest.mark.gpu

COEFS = (4.0, -1.2, -0.8, -1.1, -0.9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [75, 300, 1024])
def test_k1_matches_plain(cuda_device, dtype, n):
    x = to_torch(seeded(19, (n, n)), cuda_device).to(dtype)
    top = to_torch(seeded(20, n), cuda_device).to(dtype)
    bot = to_torch(seeded(21, n), cuda_device).to(dtype)
    before = tst.stencil5_cuda.launches
    y = tst.stencil_5pt_pallas(x, COEFS)
    yh = tst.stencil_5pt_pallas_halo(x, top, bot, COEFS)
    torch.cuda.synchronize()
    assert tst.stencil5_cuda.launches == before + 2
    # Built with -fmad=false: the same roundings as the plain version.
    torch.testing.assert_close(y, tst.stencil_5pt_general(x, *COEFS), rtol=0, atol=0)
    torch.testing.assert_close(yh, tst.stencil_5pt_halo(x, top, bot, COEFS),
                               rtol=0, atol=0)


def test_k1_refuses_what_it_does_not_take(cuda_device):
    with pytest.raises(TypeError):
        tst.stencil_5pt_routed(torch.zeros((8, 8), dtype=torch.float16,
                                           device=cuda_device))
    x = torch.zeros((8, 16), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tst.stencil5_cuda(x.T)
    with pytest.raises(ValueError, match="halo row"):
        tst.stencil5_cuda(x, torch.zeros(8, device=cuda_device))


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
@pytest.mark.parametrize("n,order", [(16, 32), (75, 32), (75, 3), (150, 3),
                                     (300, 3), (300, 1), (300, 2), (64, 200)])
def test_k2_matches_plain(cuda_device, dtype, rtol, n, order):
    """K2 on the path chebk_plan routes (a fused path, or one launch per
    sweep, also for a grid with more sweeps than the fused paths carry)
    against the plain recurrence. The plain version divides by θ as a
    multiplication by 1/θ (PyTorch's rule for a scalar divisor on CUDA), a
    last-bit difference that the deep polynomials amplify."""
    lam_min = 8.0 * np.sin(np.pi / (2 * (n + 1))) ** 2
    theta, _, steps = tfu.chebyshev_k_scalars(lam_min if order > 3 else 2.0, 8.0, order)
    r = to_torch(seeded(54, (n, n)), cuda_device).to(dtype)
    before = tfu.chebk_cuda.launches
    z = tfu.chebyshev_k_poisson_pallas(r, order, lam_min if order > 3 else 2.0, 8.0)
    torch.cuda.synchronize()
    assert tfu.chebk_cuda.launches > before
    assert rel_err(z, tfu.poly_stencil_smoother_plain(r, theta, steps)) < rtol


@pytest.mark.parametrize("n", [75, 300])
def test_k2_jacobi_general_coefficients(cuda_device, n):
    """Damped Jacobi on a non-symmetric stencil (the convection-diffusion
    smoother's form), on both K2 paths."""
    theta, steps = tfu.jacobi_k_scalars(0.7, COEFS[0], 8)
    r = to_torch(seeded(55, (n, n)), cuda_device).to(torch.float32)
    z = tfu.poly_stencil_smoother_pallas(r, theta, steps, COEFS)
    assert rel_err(z, tfu.poly_stencil_smoother_plain(r, theta, steps, COEFS)) < 1e-5


def _k2_case(device, dtype, shape, order, seed=56):
    lam_min = 8.0 * np.sin(np.pi / (2 * (max(shape) + 1))) ** 2
    theta, _, steps = tfu.chebyshev_k_scalars(lam_min if order > 3 else 2.0, 8.0, order)
    return to_torch(seeded(seed, shape), device).to(dtype), theta, steps


# Largest first: the tiles the fused-path tests force, where they fit.
K2_TILES = ((32, 128), (16, 64), (16, 32), (8, 16))


def _k2_forced_paths(r, nsteps):
    """Every cluster size that can hold r (one and four ghost rows), and the
    largest tile that fits."""
    rows, cols = r.shape
    item = r.element_size()
    paths = [("cluster", (c, g)) for c in tfu.CLUSTER_SIZES
             for g in ((0,) if c == 1 else (1, 4))
             if tfu.cluster_fits(rows, cols, c, g, item)
             and tfu._cluster_schedulable(item == 8, rows, cols, c,
                                          tfu.cluster_threads(rows, cols, c, g), g,
                                          r.device.index) > 0]
    tiles = [t for t in K2_TILES if tfu.tile_fits(t, nsteps, item)]
    return paths + [("tiled", tiles[0])] if tiles else paths


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,order", [
    ((16, 16), 3), ((16, 16), 32), ((75, 75), 3), ((75, 75), 32), ((128, 128), 3),
    ((128, 128), 32), ((150, 150), 3), ((150, 150), 32), ((300, 300), 3),
    ((300, 300), 32), ((1024, 1024), 3), ((1024, 1024), 8), ((2048, 2048), 3),
    ((2048, 2048), 8), ((75, 300), 3), ((75, 300), 32), ((301, 97), 3), ((301, 97), 32)])
def test_k2_fused_paths_bitwise_to_sweep_path(cuda_device, dtype, shape, order):
    """Paths A (cluster, every size that holds the grid) and B (tiled)
    forced, against path C (one launch per sweep): the same expression per
    point in the same order, built with -fmad=false, so the same bits."""
    r, theta, steps = _k2_case(cuda_device, dtype, shape, order)
    ref = tfu.chebk_cuda(r, theta, steps, _path=("sweep", None))
    paths = _k2_forced_paths(r, order - 1)
    if max(shape) <= 150 or dtype == torch.float32 and max(shape) <= 300:
        assert any(p == "cluster" for p, _ in paths), paths
    # No tile holds a 31-cell halo in float64 within four chunks a thread.
    if order <= 8 or dtype == torch.float32:
        assert any(p == "tiled" for p, _ in paths), paths
    for path in paths:
        before = dict(tfu.chebk_cuda.launches_by_path)
        z = tfu.chebk_cuda(r, theta, steps, _path=path)
        torch.cuda.synchronize()
        assert tfu.chebk_cuda.launches_by_path[path[0]] == before[path[0]] + 1
        torch.testing.assert_close(z, ref, rtol=0, atol=0, msg=f"{path}")


@pytest.mark.parametrize("n", [75, 300])
def test_k2_fused_paths_on_general_coefficients(cuda_device, n):
    """Damped Jacobi on the non-symmetric COEFS, every path bitwise to C."""
    theta, steps = tfu.jacobi_k_scalars(0.7, COEFS[0], 8)
    r = to_torch(seeded(57, (n, n)), cuda_device).to(torch.float32)
    ref = tfu.chebk_cuda(r, theta, steps, COEFS, _path=("sweep", None))
    for path in _k2_forced_paths(r, 7):
        torch.testing.assert_close(tfu.chebk_cuda(r, theta, steps, COEFS, _path=path),
                                   ref, rtol=0, atol=0, msg=f"{path}")


def test_k2_refuses_what_no_path_takes(cuda_device):
    from gmres_tpu_torch.ops import _cuda

    assert _cuda.load().gt_chebk_max_fused_steps() == tfu.CHEBK_MAX_FUSED_STEPS
    theta, _, steps = tfu.chebyshev_k_scalars(2.0, 8.0, 3)
    big = torch.zeros((2048, 2048), device=cuda_device)
    with pytest.raises(ValueError, match="cluster"):
        tfu.chebk_cuda(big, theta, steps, _path=("cluster", (16, 4)))
    with pytest.raises(ValueError, match="shared memory"):
        tfu.chebk_cuda(big, theta, steps, _path=("tiled", (256, 256)))
    with pytest.raises(ValueError, match="sweeps"):
        tfu.chebk_cuda(big[:16].contiguous(), 1.0, [0.0, 1.0] * 200,
                       _path=("tiled", (16, 16)))
    with pytest.raises(ValueError, match="too large"):
        tfu.chebk_cuda(torch.zeros((65535 * 8 + 1, 1), device=cuda_device), theta, steps)
    with pytest.raises(TypeError):
        tfu.chebk_cuda(big.half(), theta, steps)


def test_mg_solve_runs_on_the_kernels_and_matches_cpu(cuda_device):
    """The mg configuration at 64² on the card launches K1 and K2, converges
    on the float64 true residual, and agrees with the port's CPU solve. K2
    launches by path are chebk_plan's choices for each smoother and the
    coarse solve, times the V-cycles run."""
    n = 64
    b = np_poisson(np.ones((n, n)))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        k1, k2 = tst.stencil5_cuda.launches, tfu.chebk_cuda.launches
        by_path = dict(tfu.chebk_cuda.launches_by_path)
        m_inv = tt.poisson_multigrid_preconditioner(n)
        cycles = {}

        def counted_m(v, m_inv=m_inv, cycles=cycles):
            cycles[v.dtype] = cycles.get(v.dtype, 0) + 1
            return m_inv(v)

        res = tt.gmres(tt.poisson_operator(n), tt.as_tensor(b, dev), restart=10,
                       tol=1e-8, M=counted_m, compute_v_err=False,
                       inner_dtype=torch.float32, certify="true")
        x = res.x.cpu().numpy()
        rel = np.linalg.norm(b - np_poisson(x)) / np.linalg.norm(b)
        out[dev.type] = (res, rel, tst.stencil5_cuda.launches - k1,
                         tfu.chebk_cuda.launches - k2,
                         {p: tfu.chebk_cuda.launches_by_path[p] - by_path[p] for p in by_path},
                         m_inv.plan, cycles)
    (rg, relg, k1g, k2g, pg, plan, cyc), (rc, relc, k1c, k2c, pc, _, _) = (
        out["cuda"], out["cpu"])
    assert rg.status == rc.status == 0 and relg <= 1e-8 and relc <= 1e-8
    assert k1g > 0 and k2g > 0 and k1c == 0 and k2c == 0
    assert abs((rg.restarts - 1) * 10 + rg.iterations
               - (rc.restarts - 1) * 10 - rc.iterations) <= 2
    expected = {"cluster": 0, "tiled": 0, "sweep": 0}
    calls = [(s, len(plan.pre_smooth[1]) // 2, 1) for s in plan.sizes[:-1]]
    calls += [(s, len(plan.post_smooth[1]) // 2, 1) for s in plan.sizes[:-1]]
    calls += [(plan.sizes[-1], len(plan.coarse[1]) // 2, 1)]
    for dtype, n_cycles in cyc.items():
        for size, nsteps, per_cycle in calls:
            path, _ = tfu.chebk_plan(size, size, nsteps, dtype)
            expected[path] += n_cycles * per_cycle * (max(nsteps, 1) if path == "sweep" else 1)
    assert pg == expected and sum(pg.values()) == k2g
    assert pc == {"cluster": 0, "tiled": 0, "sweep": 0}


# ---------------------------------------------------------------------------
# K3 (DIA SpMV) and K4 (BSR SpMV).
# ---------------------------------------------------------------------------


def _wide_dia(device, dtype, n=700, offsets=(-301, -128, -17, 0, 17, 256, 301)):
    rng = np.random.default_rng(60)
    dense = np.zeros((n, n))
    for off in offsets:
        dense += np.diag(rng.standard_normal(n - abs(off)), k=off)
    return tt.dia_from_dense(dense, device=device, dtype=dtype)


def _block_tridiagonal(device, dtype, nbr, bs, seed=61):
    """Random blocks on the block tridiagonal; the first and last block rows
    carry one all-zero padding block with block column 0."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((nbr, 3, bs, bs))
    cols = np.stack([np.arange(nbr) - 1, np.arange(nbr), np.arange(nbr) + 1], 1)
    data[0, 0] = 0.0
    cols[0] = (0, 0, 1)
    data[-1, 2] = 0.0
    cols[-1] = (nbr - 2, nbr - 1, 0)
    a = tt.sparse_from_numpy("bsr", {"data": data, "block_cols": cols},
                             (nbr * bs, nbr * bs), device=device)
    return tsp.BSRMatrix(data=a.data.to(dtype), block_cols=a.block_cols,
                         shape=a.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["poisson 300", "poisson 1024", "wide 700",
                                  "hyb 64", "199 diagonals"])
def test_k3_matches_plain_bitwise(cuda_device, dtype, case):
    """Built with -fmad=false and summed in offset order from zero, K3 gives
    dia_spmv's bits on finite inputs; 199 diagonals take four launches that
    keep that order."""
    if case.startswith("poisson"):
        a = tt.poisson_dia(int(case.split()[1]), dtype=dtype, device=cuda_device)
    elif case == "wide 700":
        a = _wide_dia(cuda_device, dtype)
    elif case == "hyb 64":
        a = tt.csr_to_hyb(tt.poisson_csr(64, dtype=dtype, device=cuda_device)).dia
    else:
        a = tt.dia_from_dense(seeded(62, (100, 100)), device=cuda_device, dtype=dtype)
        assert a.ndiags == 199
    x = to_torch(seeded(63, a.shape[1]), cuda_device).to(dtype)
    before = tsp.dia_spmv_cuda.launches
    y = tsp.dia_spmv_pallas(a, x)
    torch.cuda.synchronize()
    assert tsp.dia_spmv_cuda.launches - before == -(-a.ndiags // 64)
    torch.testing.assert_close(y, tsp.dia_spmv(a, x), rtol=0, atol=0)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-13)])
@pytest.mark.parametrize("nbr,bs", [(16, 128), (64, 64), (40, 8), (7, 100)])
def test_k4_matches_einsum(cuda_device, dtype, rtol, nbr, bs):
    """K4 against the einsum of bsr_spmv, whose order of sums is cuBLAS's:
    within rtol of max|y|."""
    a = _block_tridiagonal(cuda_device, dtype, nbr, bs)
    x = to_torch(seeded(64, nbr * bs), cuda_device).to(dtype)
    before = tsp.bsr_spmv_cuda.launches
    y = tsp.bsr_spmv_pallas(a, x)
    torch.cuda.synchronize()
    assert tsp.bsr_spmv_cuda.launches == before + 1
    assert rel_err(y, tsp.bsr_spmv(a, x)) < rtol


def test_k3_k4_refuse_what_they_do_not_take(cuda_device):
    a = tt.poisson_dia(8, dtype=torch.float32, device=cuda_device)
    with pytest.raises(TypeError):
        tsp.dia_spmv_pallas(a, torch.zeros(64, dtype=torch.float64, device=cuda_device))
    with pytest.raises(TypeError):
        tsp.dia_spmv_pallas(tt.poisson_dia(8, dtype=torch.float16, device=cuda_device),
                            torch.zeros(64, dtype=torch.float16, device=cuda_device))
    with pytest.raises(ValueError, match="operand on"):
        tsp.dia_spmv_pallas(tt.poisson_dia(8, device="cpu"),
                            torch.zeros(64, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError, match="do not fit"):
        tsp.dia_spmv_pallas(a, torch.zeros(63, dtype=torch.float32, device=cuda_device))
    b = _block_tridiagonal(cuda_device, torch.float32, 4, 8)
    with pytest.raises(ValueError, match="do not fit"):
        tsp.bsr_spmv_pallas(b, torch.zeros(31, device=cuda_device))


def test_sparse_cg_runs_on_the_kernels(cuda_device):
    """cbpr2 CG at 64² on the HYB operator launches K3, on the BSR operator
    K4; both converge to tol 1e-9 and take within 2 iterations of each
    other and of the port's CPU solve."""
    n = 64
    b = np_poisson(np.ones((n, n))).reshape(-1)
    iters = {}
    for name, dev in (("hyb", cuda_device), ("bsr", cuda_device), ("cpu", "cpu")):
        if name == "bsr":
            mat = tt.bsr_from_dense(tt.poisson_matrix(n, device="cpu").numpy(), n,
                                    device=dev)
        else:
            mat = tt.csr_to_hyb(tt.poisson_csr(n, device=dev))
        op = tt.sparse_operator(mat)
        k3, k4 = tsp.dia_spmv_cuda.launches, tsp.bsr_spmv_cuda.launches
        res = tt.cg(op, tt.as_tensor(b, dev), tol=1e-9,
                    M=tt.chebyshev_preconditioner(op, 0.2, 8.2))
        x = res.x.cpu().numpy().reshape(n, n)
        assert res.status == 0
        assert np.linalg.norm(b - np_poisson(x).reshape(-1)) < 1e-9
        launched = (tsp.dia_spmv_cuda.launches - k3, tsp.bsr_spmv_cuda.launches - k4)
        # One SpMV in M(b) before the loop, two per iteration (A p and the
        # one inside cbpr2), one in the final certification.
        assert launched == {"hyb": (2 * res.iterations + 2, 0),
                            "bsr": (0, 2 * res.iterations + 2),
                            "cpu": (0, 0)}[name]
        iters[name] = res.iterations
    assert max(iters.values()) - min(iters.values()) <= 2


# ---------------------------------------------------------------------------
# K5 (fused cbpr2) and K7 (fused CG update, axpy-dot); the halo path.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(304, 304), (76, 304), (1, 40), (2048, 2048)])
@pytest.mark.parametrize("halos", ["none", "random"])
def test_k5_matches_plain_bitwise(cuda_device, dtype, shape, halos):
    """Built with -fmad=false, K5 repeats the plain version's roundings."""
    r = to_torch(seeded(70, shape), cuda_device).to(dtype)
    top = bot = None
    if halos == "random":
        top = to_torch(seeded(71, (1, shape[1])), cuda_device).to(dtype)
        bot = to_torch(seeded(72, shape[1]), cuda_device).to(dtype)
    d, alpha = tfu.chebyshev_ref_scalars(0.2, 8.2)
    before = tfu.cheb2_cuda.launches
    z = tt.chebyshev_poisson_fused(r, top, bot, d, alpha, COEFS)
    torch.cuda.synchronize()
    assert tfu.cheb2_cuda.launches == before + 1
    torch.testing.assert_close(
        z, tfu.chebyshev_poisson_fused_plain(r, top, bot, d, alpha, COEFS),
        rtol=0, atol=0)


def test_k5_k7_refuse_what_they_do_not_take(cuda_device):
    half = torch.zeros((8, 8), dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError):
        tt.chebyshev_poisson_fused(half, None, None, 4.2, 0.25)
    x = torch.zeros((8, 16), device=cuda_device)
    with pytest.raises(ValueError, match="halo row"):
        tt.chebyshev_poisson_fused(x, torch.zeros(8, device=cuda_device), None, 4.2, 0.25)
    with pytest.raises(ValueError, match="differ"):
        tt.cg_fused_update(x, x, x, x[:4], 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        tt.axpy_dot(0.5, x.T, x.T, x.T)
    with pytest.raises(TypeError):
        tt.axpy_dot(0.5, half, half, half)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(304, 304), (2048, 2048), (1000,), (7,)])
def test_k7_matches_plain(cuda_device, dtype, shape):
    """The elementwise outputs bitwise; the float32 sums, taken in another
    order than torch.sum's, to 1e-5 relative; the same bits on a second
    call (no atomics). α may be a 0-d tensor on the card."""
    x, r, p, ap = (to_torch(seeded(73 + s, shape), cuda_device).to(dtype)
                   for s in range(4))
    alpha = torch.tensor(0.37, dtype=torch.float64, device=cuda_device)
    before = (tfu.cg_fused_update_cuda.launches, tfu.axpy_dot_cuda.launches)
    xo, ro, rsq = tt.cg_fused_update(x, r, p, ap, alpha)
    yo, dot = tt.axpy_dot(-1.25, x, r, p)
    torch.cuda.synchronize()
    assert (tfu.cg_fused_update_cuda.launches, tfu.axpy_dot_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    xp, rp, rsqp = tfu.cg_fused_update_plain(x, r, p, ap, alpha)
    yp, dotp = tfu.axpy_dot_plain(-1.25, x, r, p)
    torch.testing.assert_close(xo, xp, rtol=0, atol=0)
    torch.testing.assert_close(ro, rp, rtol=0, atol=0)
    torch.testing.assert_close(yo, yp, rtol=0, atol=0)
    assert rsq.dtype == dot.dtype == torch.float32 and rsq.shape == dot.shape == ()
    assert abs(float(rsq) - float(rsqp)) <= 1e-5 * abs(float(rsqp))
    assert abs(float(dot) - float(dotp)) <= 1e-5 * float((yp.float() * p.float()).abs().sum())
    assert float(tt.cg_fused_update(x, r, p, ap, alpha)[2]) == float(rsq)


def test_halo_path_runs_on_the_kernels(cuda_device, tmp_path):
    """On a one-rank mesh of the card (an NCCL group made here, on a file
    rendezvous), the halo operator launches K1 and the order-2 halo
    preconditioner K5; MGSR GMRES on them converges. The RDMA operators
    launch K8 and give the bits of the plain route on the CPU."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        _halo_path_on_one_rank(cuda_device)
        _rdma_path_on_one_rank(cuda_device)
    finally:
        dist.destroy_process_group()


def _halo_path_on_one_rank(cuda_device):
    n = 64
    mesh = tt.solver_mesh(1)
    b_np = np_poisson(np.ones((n, n)))
    b = tt.shard_grid_vector(tt.as_tensor(b_np, cuda_device), mesh)
    op = tt.halo_poisson_operator(mesh)
    m_inv = tt.halo_chebyshev_preconditioner(mesh, 0.2, 8.2)
    x = tt.shard_grid_vector(to_torch(seeded(74, (n, n)), cuda_device), mesh)
    k1, k5 = tst.stencil5_cuda.launches, tfu.cheb2_cuda.launches
    y, z = op(x), m_inv(x)
    torch.cuda.synchronize()
    assert (tst.stencil5_cuda.launches, tfu.cheb2_cuda.launches) == (k1 + 1, k5 + 1)
    assert rel_err(y.to_local(), np_poisson(seeded(74, (n, n)))) < 1e-14
    res = tt.gmres(op, b, restart=20, tol=1e-10, M=m_inv, variant="mgsr",
                   compute_v_err=False)
    xs = res.x.full_tensor().cpu().numpy()
    assert res.status == 0
    assert np.linalg.norm(b_np - np_poisson(xs)) / np.linalg.norm(b_np) < 1e-9
    assert tfu.cheb2_cuda.launches > k5 + 1


def _rdma_path_on_one_rank(cuda_device):
    from gmres_tpu_torch.parallel.halo import (
        rdma_chebyshev_preconditioner,
        rdma_stencil_operator,
    )

    n = 64
    mesh = tt.solver_mesh(1)
    group = mesh.get_group("grid")
    x_np = seeded(75, (n, n)).astype(np.float32)
    x = tt.shard_grid_vector(to_torch(x_np, cuda_device), mesh)
    op = rdma_stencil_operator(mesh, COEFS)
    m_inv = rdma_chebyshev_preconditioner(mesh, 0.2, 8.2)
    d, alpha = tfu.chebyshev_ref_scalars(0.2, 8.2)
    before = (trd.rdma_interior_cuda.launches, trd.rdma_edges_cuda.launches)
    y, z = op(x).to_local(), m_inv(x).to_local()
    torch.cuda.synchronize()
    assert (trd.rdma_interior_cuda.launches, trd.rdma_edges_cuda.launches) == (
        before[0] + 2, before[1] + 2)
    # The plain route on a CPU block of the same one-rank group.
    x_cpu = to_torch(x_np)
    torch.testing.assert_close(
        y.cpu(), trd.stencil_5pt_rdma(x_cpu, (*COEFS, 0.0, 1.0), group), rtol=0, atol=0)
    torch.testing.assert_close(
        z.cpu(), trd.stencil_5pt_rdma(x_cpu, (*tst.POISSON_COEFS, 1.0 / d + alpha,
                                              -alpha / d), group), rtol=0, atol=0)
    b_np = np_poisson(np.ones((n, n))).astype(np.float32)
    b = tt.shard_grid_vector(to_torch(b_np, cuda_device), mesh)
    a = rdma_stencil_operator(mesh)
    k8 = trd.rdma_interior_cuda.launches
    res = tt.gmres(a, b, restart=30, tol=1e-5, M=m_inv, max_restarts=20,
                   variant="mgsr", compute_v_err=False)
    assert res.status == 0 and trd.rdma_interior_cuda.launches > k8
    np.testing.assert_allclose(res.x.full_tensor().cpu().numpy(), 1.0, atol=1e-3)


# ---------------------------------------------------------------------------
# K6 (the stencil on (hi, lo) float32 pairs) and K8 (the RDMA route's
# affine stencil).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coefs", [tst.POISSON_COEFS, COEFS], ids=["poisson", "general"])
@pytest.mark.parametrize("shape", [(2048, 2048), (77, 130)])
def test_k6_matches_plain_bitwise(cuda_device, coefs, shape):
    """K6 works in float64 in the plain version's order (-fmad=false): both
    components bitwise; and within 1e-13 of the float64 oracle."""
    x = to_torch(seeded(80, shape), cuda_device)
    hi, lo = tdd.dd_from_f64(x)
    before = tst.stencil5_dd_cuda.launches
    yk = tst.stencil_5pt_dd_general_pallas_blocked(hi, lo, coefs)
    torch.cuda.synchronize()
    assert tst.stencil5_dd_cuda.launches == before + 1
    yp = tst.stencil_5pt_dd_plain(hi, lo, coefs)
    assert yk[0].dtype == yk[1].dtype == torch.float32
    torch.testing.assert_close(yk[0], yp[0], rtol=0, atol=0)
    torch.testing.assert_close(yk[1], yp[1], rtol=0, atol=0)
    assert rel_err(tdd.dd_to_f64(yk), tst.stencil_5pt_general(x, *coefs)) < 1e-13


def test_k6_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros((8, 8), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        tst.stencil_5pt_dd_pallas_blocked(x, x)
    h = torch.zeros((8, 8), device=cuda_device)
    with pytest.raises(ValueError, match="differ"):
        tst.stencil_5pt_dd_pallas_blocked(h, torch.zeros((8, 9), device=cuda_device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(304, 304), (2048, 2048), (1, 40)])
@pytest.mark.parametrize("halos", ["zero", "random"])
def test_k8_matches_plain_bitwise(cuda_device, dtype, shape, halos):
    """Interior then edges, as the operator runs them, for the stencil
    (a, b) = (0, 1) and cbpr2's affine form: the plain version's bits."""
    d, alpha = tfu.chebyshev_ref_scalars(0.2, 8.2)
    x = to_torch(seeded(81, shape), cuda_device).to(dtype)
    top = torch.zeros((1, shape[1]), dtype=dtype, device=cuda_device)
    bot = torch.zeros_like(top)
    if halos == "random":
        top = to_torch(seeded(82, (1, shape[1])), cuda_device).to(dtype)
        bot = to_torch(seeded(83, (1, shape[1])), cuda_device).to(dtype)
    for ab in ((0.0, 1.0), (1.0 / d + alpha, -alpha / d)):
        c = trd._coefs7((*COEFS, *ab), dtype)
        before = (trd.rdma_interior_cuda.launches, trd.rdma_edges_cuda.launches)
        yk = trd.rdma_edges_cuda(trd.rdma_interior_cuda(x, c), top, bot, c)
        torch.cuda.synchronize()
        assert (trd.rdma_interior_cuda.launches, trd.rdma_edges_cuda.launches) == (
            before[0] + 1, before[1] + 1)
        yp = trd.rdma_edges_plain(trd.rdma_interior_plain(x, c), top, bot, c)
        torch.testing.assert_close(yk, yp, rtol=0, atol=0)


def test_k8_refuses_what_it_does_not_take(cuda_device):
    c = trd._coefs7((*COEFS, 0.0, 1.0), torch.float16)
    with pytest.raises(TypeError):
        trd.rdma_interior_cuda(torch.zeros((8, 8), dtype=torch.float16,
                                           device=cuda_device), c)
    y = torch.zeros((8, 16), device=cuda_device)
    with pytest.raises(ValueError, match="halo row"):
        trd.rdma_edges_cuda(y, torch.zeros(8, device=cuda_device),
                            torch.zeros(16, device=cuda_device), c)
