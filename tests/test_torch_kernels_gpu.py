"""Kernels K1–K8 of the PyTorch port on the card, against their plain
PyTorch versions, and the main paths' use of them (BiCGSTAB, the Lanczos
bounds, the reference's programs and the convection-diffusion cycle and
program among them).

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


def _offset(t):
    """t's values in a contiguous tensor one element past an aligned start,
    so that no vector or pair access is aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("layout", ["aligned", "offset"])
@pytest.mark.parametrize("shape,dtype", [((304, 304), torch.float64), ((300, 300), torch.float32),
                                         ((75, 301), torch.float32), ((2048, 2048), torch.float32),
                                         ((1024, 1024), torch.float64), ((1024, 1026), torch.float32)])
def test_k1_row_chunks_bitwise(cuda_device, shape, dtype, layout):
    """K1 with 16-byte row chunks (aligned grids of 1024² points or more
    whose row length allows) and one point a thread (smaller grids, odd row
    lengths, offset pointers), with null and given halo rows: the plain
    version's bits."""
    x = to_torch(seeded(22, shape), cuda_device).to(dtype)
    top = to_torch(seeded(23, shape[1]), cuda_device).to(dtype)
    if layout == "offset":
        x, top = _offset(x), _offset(top)
    for halo in ((None, None), (top, None)):
        before = tst.stencil5_cuda.launches
        y = tst.stencil5_cuda(x, *halo, COEFS)
        torch.cuda.synchronize()
        assert tst.stencil5_cuda.launches == before + 1
        torch.testing.assert_close(y, tst.stencil_5pt_halo(x, *halo, COEFS),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["aligned", "offset"])
@pytest.mark.parametrize("shape,dtype", [((300, 300), torch.float32), ((150, 150), torch.float32),
                                         ((2048, 2048), torch.float32), ((304, 304), torch.float64),
                                         ((16, 40), torch.float64)])
def test_k1_fused_forms_bitwise(cuda_device, shape, dtype, layout):
    """K1's residual-restrict and correct-residual forms against their plain
    versions (the compositions the V-cycle ran before): the same bits, with
    pair accesses aligned or not, on the Poisson and on general
    coefficients."""
    r = to_torch(seeded(24, shape), cuda_device).to(dtype)
    e = to_torch(seeded(25, shape), cuda_device).to(dtype)
    ec = to_torch(seeded(26, (shape[0] // 2, shape[1] // 2)), cuda_device).to(dtype)
    if layout == "offset":
        r, e = _offset(r), _offset(e)
    for coefs in (tst.POISSON_COEFS, COEFS):
        before = (tst.residual_restrict_cuda.launches, tst.correct_residual_cuda.launches)
        rc = tst.residual_restrict_cuda(r, e, coefs)
        e2, r3 = tst.correct_residual_cuda(r, e, ec, coefs)
        torch.cuda.synchronize()
        assert (tst.residual_restrict_cuda.launches,
                tst.correct_residual_cuda.launches) == (before[0] + 1, before[1] + 1)
        torch.testing.assert_close(rc, tst.residual_restrict_plain(r, e, coefs),
                                   rtol=0, atol=0)
        e2p, r3p = tst.correct_residual_plain(r, e, ec, coefs)
        torch.testing.assert_close(e2, e2p, rtol=0, atol=0)
        torch.testing.assert_close(r3, r3p, rtol=0, atol=0)


def test_k1_fused_forms_refuse_what_they_do_not_take(cuda_device):
    r = torch.zeros((8, 12), device=cuda_device)
    with pytest.raises(ValueError, match="even sides"):
        tst.residual_restrict(r[:7].contiguous(), r[:7].contiguous())
    with pytest.raises(ValueError, match="float32"):
        tst.correct_residual(r, r, torch.zeros((4, 6), dtype=torch.float64,
                                               device=cuda_device))
    with pytest.raises(TypeError):
        tst.residual_restrict(r.half(), r.half())


@pytest.mark.parametrize("n", [64, 300])
def test_v_cycle_on_fused_forms_bitwise_to_the_composition(cuda_device, n):
    """The V-cycle on the card (K2 and the fused K1 forms) against the same
    cycle built from the composition on the card (K2, K1, torch's
    transfers): the same bits, and one launch of each form a level."""
    m_inv = tt.poisson_multigrid_preconditioner(n)
    plan = m_inv.plan

    def composed(r, level=0):
        if level == len(plan.sizes) - 1:
            return tfu.chebk_cuda(r, *plan.coarse)
        e = tfu.chebk_cuda(r, *plan.pre_smooth)
        ec = composed(tt.restrict_sum(r - tst.stencil5_cuda(e)), level + 1)
        e = e + tt.prolong_repeat(ec)
        return e + tfu.chebk_cuda(r - tst.stencil5_cuda(e), *plan.post_smooth)

    r = to_torch(seeded(27, (n, n)), cuda_device).to(torch.float32)
    before = (tst.residual_restrict_cuda.launches, tst.correct_residual_cuda.launches,
              tst.stencil5_cuda.launches)
    z = m_inv(r)
    torch.cuda.synchronize()
    assert (tst.residual_restrict_cuda.launches - before[0],
            tst.correct_residual_cuda.launches - before[1],
            tst.stencil5_cuda.launches - before[2]) == (m_inv.levels - 1,) * 2 + (0,)
    torch.testing.assert_close(z, composed(r), rtol=0, atol=0)


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


def test_k2_routes_around_an_unschedulable_cluster(cuda_device, monkeypatch):
    """With the schedulable-cluster count at 0, the unforced mg coarse solve
    at 75² takes the tiled path (counted there) with the per-sweep path's
    bits; a forced cluster path raises."""
    r, theta, steps = _k2_case(cuda_device, torch.float32, (75, 75), 32)
    ref = tfu.chebk_cuda(r, theta, steps, _path=("sweep", None))
    monkeypatch.setattr(tfu, "_cluster_schedulable", lambda *args: 0)
    before = dict(tfu.chebk_cuda.launches_by_path)
    z = tfu.chebk_cuda(r, theta, steps)
    torch.cuda.synchronize()
    assert tfu.chebk_cuda.launches_by_path["tiled"] == before["tiled"] + 1
    assert tfu.chebk_cuda.launches_by_path["cluster"] == before["cluster"]
    torch.testing.assert_close(z, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="cluster"):
        tfu.chebk_cuda(r, theta, steps, _path=("cluster", (16, 4)))


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
@pytest.mark.parametrize("shape", [(304, 304), (76, 304), (1, 40), (2048, 2048), (75, 301)])
@pytest.mark.parametrize("halos", ["none", "random", "random offset"])
def test_k5_matches_plain_bitwise(cuda_device, dtype, shape, halos):
    """Built with -fmad=false, K5 repeats the plain version's roundings, with
    null and with given halo rows, aligned or offset, through the routed
    entry, the launch wrapper and the per-application entry."""
    r = to_torch(seeded(70, shape), cuda_device).to(dtype)
    top = bot = None
    if halos != "none":
        top = to_torch(seeded(71, (1, shape[1])), cuda_device).to(dtype)
        bot = to_torch(seeded(72, shape[1]), cuda_device).to(dtype)
    if halos == "random offset":
        r, top = _offset(r), _offset(top)
    d, alpha = tfu.chebyshev_ref_scalars(0.2, 8.2)
    plain = tfu.chebyshev_poisson_fused_plain(r, top, bot, d, alpha, COEFS)
    before = tfu.cheb2_cuda.launches
    z = tt.chebyshev_poisson_fused(r, top, bot, d, alpha, COEFS)
    torch.cuda.synchronize()
    assert tfu.cheb2_cuda.launches == before + 1
    torch.testing.assert_close(z, plain, rtol=0, atol=0)
    torch.testing.assert_close(tfu.cheb2_cuda(r, top, bot, d, alpha, COEFS), plain,
                               rtol=0, atol=0)
    scal = tfu.cheb2_scalars(d, alpha, COEFS, dtype)
    torch.testing.assert_close(tfu.cheb2_apply(r, top, bot, scal), plain, rtol=0, atol=0)


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
@pytest.mark.parametrize("shape", [(304, 304), (2048, 2048), (1000,), (7,), (301, 3)])
def test_k7_matches_plain(cuda_device, dtype, shape):
    """The elementwise outputs bitwise; the float32 sums, taken in another
    order than torch.sum's, to 1e-5 relative; one launch a call; the same
    bits on a second call and after another stream has run K7 (the atomic
    orders tickets, not the sum); α as a Python float and as a 0-d tensor
    on the card (of float64 or the vectors' dtype) give the same bits."""
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

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(a, b))

    first = (xo, ro, rsq)
    assert same(tt.cg_fused_update(x, r, p, ap, alpha), first)
    for a in (0.37, torch.tensor(0.37, dtype=dtype, device=cuda_device)):
        assert same(tt.cg_fused_update(x, r, p, ap, a), first)
    assert same(tt.axpy_dot(torch.tensor(-1.25, device=cuda_device, dtype=torch.float64),
                            x, r, p), (yo, dot))
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        on_side = tt.cg_fused_update(x, r, p, ap, 0.37), tt.axpy_dot(-1.25, x, r, p)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    again = tt.cg_fused_update(x, r, p, ap, 0.37), tt.axpy_dot(-1.25, x, r, p)
    torch.cuda.synchronize()
    assert same(on_side[0], first) and same(on_side[1], (yo, dot))
    assert same(again[0], first) and same(again[1], (yo, dot))


def test_k7_in_a_cuda_graph(cuda_device):
    """K7 captured in a CUDA graph and replayed gives the eager call's bits
    at every replay: its counter is back at 0 after each launch."""
    x, r, p, ap = (to_torch(seeded(76 + s, (304, 304)), cuda_device) for s in range(4))
    eager = tt.cg_fused_update(x, r, p, ap, 0.37), tt.axpy_dot(0.5, x, r, p)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tt.cg_fused_update(x, r, p, ap, 0.37), tt.axpy_dot(0.5, x, r, p)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert all(torch.equal(u, v) for u, v in zip(got, want))


def test_k7_with_a_python_alpha_does_not_synchronise(cuda_device):
    """A Python α goes to K7 by value: a call, under
    torch.cuda.set_sync_debug_mode("error"), makes no synchronising call."""
    x, r, p, ap = (to_torch(seeded(77 + s, (304, 304)), cuda_device) for s in range(4))
    tt.cg_fused_update(x, r, p, ap, 0.37)
    tt.axpy_dot(0.5, x, r, p)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tt.cg_fused_update(x, r, p, ap, 0.37)
        tt.axpy_dot(0.5, x, r, p)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


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
    # No halo rows on one rank: the plain versions with none give the bits.
    d, alpha = tfu.chebyshev_ref_scalars(0.2, 8.2)
    torch.testing.assert_close(y.to_local(), tst.stencil_5pt_halo(x.to_local(), None, None),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        z.to_local(), tfu.chebyshev_poisson_fused_plain(x.to_local(), None, None, d, alpha),
        rtol=0, atol=0)
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
    # One rank: no neighbour, no halo row, no edge launch.
    assert (trd.rdma_interior_cuda.launches, trd.rdma_edges_cuda.launches) == (
        before[0] + 2, before[1])
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
@pytest.mark.parametrize("shape", [(304, 304), (2048, 2048), (1, 40), (1024, 1026)])
@pytest.mark.parametrize("halos", ["zero", "random", "none", "one-sided", "random offset"])
def test_k8_matches_plain_bitwise(cuda_device, dtype, shape, halos):
    """Interior then edges, as the operator runs them, for the stencil
    (a, b) = (0, 1) and cbpr2's affine form: the plain version's bits with
    zero, random and absent (None) halo rows, and with none on top only. An
    absent row is no correction, and with neither row no edge kernel
    launches: the result equals the zero-row composition (rtol=0, atol=0
    treats −0.0 and +0.0 as equal, the one difference). At 2048² the
    interior takes 16-byte row chunks; inputs one element off alignment,
    and 1026-column rows in float32, take one point a thread."""
    d, alpha = tfu.chebyshev_ref_scalars(0.2, 8.2)
    x = to_torch(seeded(81, shape), cuda_device).to(dtype)
    zero = torch.zeros((1, shape[1]), dtype=dtype, device=cuda_device)
    rand_top, rand_bot = (to_torch(seeded(s, (1, shape[1])), cuda_device).to(dtype)
                          for s in (82, 83))
    top, bot = {"zero": (zero, torch.zeros_like(zero)), "random": (rand_top, rand_bot),
                "none": (None, None), "one-sided": (None, rand_bot),
                "random offset": (_offset(rand_top), _offset(rand_bot))}[halos]
    if halos == "random offset":
        x = _offset(x)
    edge_launches = 0 if top is None and bot is None else 1
    for ab in ((0.0, 1.0), (1.0 / d + alpha, -alpha / d)):
        c = trd._coefs7((*COEFS, *ab), dtype)
        before = (trd.rdma_interior_cuda.launches, trd.rdma_edges_cuda.launches)
        yk = trd.rdma_edges_cuda(trd.rdma_interior_cuda(x, c), top, bot, c)
        torch.cuda.synchronize()
        assert (trd.rdma_interior_cuda.launches, trd.rdma_edges_cuda.launches) == (
            before[0] + 1, before[1] + edge_launches)
        yp = trd.rdma_edges_plain(trd.rdma_interior_plain(x, c),
                                  zero if top is None else top,
                                  zero if bot is None else bot, c)
        torch.testing.assert_close(yk, yp, rtol=0, atol=0)
        torch.testing.assert_close(trd.rdma_edges_plain(trd.rdma_interior_plain(x, c),
                                                        top, bot, c), yp, rtol=0, atol=0)


def test_rdma_operators_are_one_kernel_on_one_rank(cuda_device, tmp_path):
    """On a one-rank NCCL mesh an application of the RDMA operator and of
    the RDMA cbpr2 is one K8 launch and no edge launch (the wrappers'
    counts), and the profiler sees no other kernel: no fills of zero rows,
    no edge kernel."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from gmres_tpu_torch.parallel.halo import (
        rdma_chebyshev_preconditioner,
        rdma_stencil_operator,
    )

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        n = 304
        mesh = tt.solver_mesh(1)
        x = tt.shard_grid_vector(to_torch(seeded(84, (n, n)), cuda_device).float(), mesh)
        for f in (rdma_stencil_operator(mesh), rdma_chebyshev_preconditioner(mesh, 0.2, 8.2)):
            f(x)
            torch.cuda.synchronize()
            before = (trd.rdma_interior_cuda.launches, trd.rdma_edges_cuda.launches)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    f(x)
                torch.cuda.synchronize()
            assert (trd.rdma_interior_cuda.launches, trd.rdma_edges_cuda.launches) == (
                before[0] + 10, before[1])
            kernels = [e.key for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.is_user_annotation]
            assert kernels and all("rdma_interior_kernel" in k for k in kernels), kernels
    finally:
        dist.destroy_process_group()


def test_k8_refuses_what_it_does_not_take(cuda_device):
    c = trd._coefs7((*COEFS, 0.0, 1.0), torch.float16)
    with pytest.raises(TypeError):
        trd.rdma_interior_cuda(torch.zeros((8, 8), dtype=torch.float16,
                                           device=cuda_device), c)
    y = torch.zeros((8, 16), device=cuda_device)
    with pytest.raises(ValueError, match="halo row"):
        trd.rdma_edges_cuda(y, torch.zeros(8, device=cuda_device),
                            torch.zeros(16, device=cuda_device), c)


# ---------------------------------------------------------------------------
# K1's halo form, K5 and K8 on lanes: the halo route's block form (a block of
# rows of a row-sharded grid, per-lane halo rows, one launch).
# ---------------------------------------------------------------------------

LANE_BLOCKS = [((8, 1024, 1024), torch.float64), ((8, 2048, 2048), torch.float32),
               ((3, 76, 304), torch.float64), ((5, 75, 301), torch.float32)]
LANE_SIDES = ["both", "top", "bottom", "none"]


def _lane_block(shape, dtype, dev, sides, seed):
    """A (lanes, rows, cols) block and its (lanes, 1, cols) halo rows, random
    per lane, None on the sides ``sides`` leaves out."""
    lanes, _, cols = shape
    x = to_torch(seeded(seed, shape), dev).to(dtype)
    top, bot = (to_torch(seeded(seed + k, (lanes, 1, cols)), dev).to(dtype) for k in (1, 2))
    return (x, top if sides in ("both", "top") else None,
            bot if sides in ("both", "bottom") else None)


def _each_lane(fn, x, top, bot):
    """fn on each lane with its own halo rows, stacked."""
    return torch.stack([fn(x[i], None if top is None else top[i],
                           None if bot is None else bot[i]) for i in range(x.shape[0])])


@pytest.mark.parametrize("shape,dtype", LANE_BLOCKS)
@pytest.mark.parametrize("sides", LANE_SIDES)
def test_k1_halo_lanes_bitwise(cuda_device, shape, dtype, sides):
    """K1's halo form on a block with per-lane halo rows: one launch (a
    batched one), each lane bitwise its own launch, and the plain lane form
    bitwise (-fmad=false). The 2048² float32 lanes take 16-byte row chunks."""
    x, top, bot = _lane_block(shape, dtype, cuda_device, sides, 990)
    before = (tst.stencil5_cuda.launches, tst.stencil5_cuda.batched_launches,
              tst.stencil_5pt_pallas_halo.batched_launches)
    y = tst.stencil_5pt_pallas_halo(x, top, bot, COEFS)
    torch.cuda.synchronize()
    assert (tst.stencil5_cuda.launches, tst.stencil5_cuda.batched_launches,
            tst.stencil_5pt_pallas_halo.batched_launches) == tuple(b + 1 for b in before)
    singles = _each_lane(lambda v, t, b: tst.stencil5_cuda(v, t, b, COEFS), x, top, bot)
    assert torch.equal(y, singles)
    torch.testing.assert_close(y, tst.stencil_5pt_halo(x, top, bot, COEFS), rtol=0, atol=0)


@pytest.mark.parametrize("shape,dtype", LANE_BLOCKS)
@pytest.mark.parametrize("sides", LANE_SIDES)
def test_k5_lanes_bitwise(cuda_device, shape, dtype, sides):
    """K5 on a block with per-lane halo rows: one launch, each lane bitwise
    its own launch and the plain lane form bitwise."""
    x, top, bot = _lane_block(shape, dtype, cuda_device, sides, 993)
    scal = tfu.cheb2_scalars(*tfu.chebyshev_ref_scalars(0.2, 8.2), COEFS, dtype)
    before = (tfu.cheb2_cuda.launches, tfu.cheb2_cuda.batched_launches)
    z = tfu.cheb2_apply(x, top, bot, scal)
    torch.cuda.synchronize()
    assert (tfu.cheb2_cuda.launches, tfu.cheb2_cuda.batched_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(z, _each_lane(lambda v, t, b: tfu.cheb2_apply(v, t, b, scal),
                                     x, top, bot))
    torch.testing.assert_close(z, tfu.cheb2_plain(x, top, bot, scal), rtol=0, atol=0)


@pytest.mark.parametrize("shape,dtype", LANE_BLOCKS)
@pytest.mark.parametrize("sides", LANE_SIDES)
def test_k8_lanes_bitwise(cuda_device, shape, dtype, sides):
    """K8's interior and edges on a block with per-lane halo rows, for the
    stencil and cbpr2's affine form: one interior launch and, where a row
    is given, one edge launch; each lane bitwise its own launches and the
    plain lane forms bitwise."""
    d, alpha = tfu.chebyshev_ref_scalars(0.2, 8.2)
    x, top, bot = _lane_block(shape, dtype, cuda_device, sides, 996)
    edge = int(top is not None or bot is not None)
    for ab in ((0.0, 1.0), (1.0 / d + alpha, -alpha / d)):
        c = trd._coefs7((*COEFS, *ab), dtype)

        def k8(v, t, b):
            return trd.rdma_edges_cuda(trd.rdma_interior_cuda(v, c), t, b, c)

        before = (trd.rdma_interior_cuda.batched_launches, trd.rdma_edges_cuda.batched_launches)
        y = k8(x, top, bot)
        torch.cuda.synchronize()
        assert (trd.rdma_interior_cuda.batched_launches,
                trd.rdma_edges_cuda.batched_launches) == (before[0] + 1, before[1] + edge)
        assert torch.equal(y, _each_lane(k8, x, top, bot))
        plain = trd.rdma_edges_plain(trd.rdma_interior_plain(x, c), top, bot, c)
        torch.testing.assert_close(y, plain, rtol=0, atol=0)


def test_lane_halo_rows_refused_when_they_do_not_match(cuda_device):
    """A block's halo rows must be (lanes, 1, cols), one a lane: one row for
    every lane, or another lane count, raises before any launch."""
    x = torch.zeros((4, 8, 16), device=cuda_device)
    before = tst.stencil5_cuda.launches
    for bad in (torch.zeros((1, 16), device=cuda_device),
                torch.zeros((3, 1, 16), device=cuda_device)):
        with pytest.raises(ValueError, match="halo row"):
            tst.stencil5_cuda(x, bad, None)
        with pytest.raises(ValueError, match="halo row"):
            tfu.cheb2_apply(x, None, bad, [1.0] * 7)
        with pytest.raises(ValueError, match="halo row"):
            trd.rdma_edges_cuda(x, bad, None, [1.0] * 7)
    assert tst.stencil5_cuda.launches == before


def test_halo_block_is_one_exchange_and_one_launch(cuda_device, tmp_path):
    """On a one-rank NCCL mesh, row_apply of the halo operator, the halo
    cbpr2 and the two RDMA operators to a (4, 256, 256) block placed
    [Shard(1)]: one exchange and one launch of the lane form a block (K1's
    halo form, K5, K8's interior; no edge launch), each row bitwise its own
    call; the order-4 Chebyshev makes one of each a sweep, and the split
    Helmholtz operator on a (4, 2, 256, 256) block placed [Shard(2)] one
    exchange and two launches of K1's halo form on lanes (one a plane), as
    one stack's application does."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from gmres_tpu_torch.ops.blas import row_apply
    from gmres_tpu_torch.parallel.halo import (
        halo_exchange,
        rdma_chebyshev_preconditioner,
        rdma_stencil_operator,
    )

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        mesh = tt.solver_mesh(1)
        x = to_torch(seeded(999, (4, 256, 256)), cuda_device)
        stacks = to_torch(seeded(998, (4, 2, 256, 256)), cuda_device)
        k1 = tst.stencil_5pt_pallas_halo
        # (operator, block, its grid rows' axis, exchanges, launches, wrapper)
        cases = (
            (tt.halo_poisson_operator(mesh), x, 1, 1, 1, k1),
            (tt.halo_chebyshev_preconditioner(mesh, 0.2, 8.2), x, 1, 1, 1, tfu.cheb2_cuda),
            (tt.halo_chebyshev_preconditioner(mesh, 0.2, 8.2, order=4), x, 1, 3, 3, k1),
            (tt.helmholtz_split_operator(256, 0.3, damping=0.2), stacks, 2, 1, 2, k1),
            (rdma_stencil_operator(mesh), x.float(), 1, 1, 1, trd.rdma_interior_cuda),
            (rdma_chebyshev_preconditioner(mesh, 0.2, 8.2), x.float(), 1, 1, 1,
             trd.rdma_interior_cuda),
        )
        for op, v, dim, exchanges, launches, wrapper in cases:
            blk = distribute_tensor(v, mesh, [Shard(dim)])
            halo_exchange.exchanges = 0
            before = (wrapper.launches, wrapper.batched_launches, trd.rdma_edges_cuda.launches)
            y = row_apply(op, blk)
            torch.cuda.synchronize()
            assert halo_exchange.exchanges == exchanges
            assert (wrapper.launches, wrapper.batched_launches) == (
                before[0] + launches, before[1] + launches)
            assert trd.rdma_edges_cuda.launches == before[2]
            for i in range(v.shape[0]):
                row = distribute_tensor(v[i], mesh, [Shard(dim - 1)])
                assert torch.equal(y.to_local()[i], op(row).to_local())
    finally:
        dist.destroy_process_group()


def test_cycle_and_sparse_blocks_are_one_launch_a_kernel(cuda_device, tmp_path):
    """On a one-rank NCCL mesh, row_apply of the mesh= Poisson cycle (256²,
    replicate_below 128: two sharded levels, then one all-gather and the
    levels below once under vmap) and of the DIA and BSR operators to a
    (4, …) block placed [Shard(1)]: one row's exchanges and all-gathers,
    every kernel launched one row's times and only on lane blocks (K1's
    halo form, K1rr, K1cr, K2; K3; K4), each row bitwise its own call."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from gmres_tpu_torch.ops.blas import row_apply
    from gmres_tpu_torch.parallel.halo import halo_exchange

    wrappers = (tst.stencil_5pt_pallas_halo, tst.residual_restrict_cuda,
                tst.correct_residual_cuda, tfu.chebk_cuda, tsp.dia_spmv_cuda,
                tsp.bsr_spmv_cuda)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        mesh = tt.solver_mesh(1)
        x = to_torch(seeded(997, (4, 256, 256)), cuda_device)
        bsr = tt.bsr_from_dense(np.kron(np.eye(8), np.ones((16, 16)))
                                + np.eye(128, k=16), 16, device=cuda_device)
        cases = ((tt.poisson_multigrid_preconditioner(256, mesh=mesh, replicate_below=128),
                  x),
                 (tt.sparse_operator(tt.poisson_dia(256, device=cuda_device)),
                  x.reshape(4, -1)),
                 (tt.sparse_operator(bsr), x.reshape(4, -1)[:, :128].contiguous()))
        for op, v in cases:
            blk = distribute_tensor(v, mesh, [Shard(1)])
            rows = [distribute_tensor(v[i], mesh, [Shard(0)]) for i in range(v.shape[0])]
            counts = {}
            for key, call in (("block", lambda: [row_apply(op, blk)]),
                              ("rows", lambda: [op(r) for r in rows])):
                halo_exchange.exchanges = 0
                before = [(w.launches, w.batched_launches) for w in wrappers]
                out = call()
                torch.cuda.synchronize()
                counts[key] = (halo_exchange.exchanges,
                               [(w.launches - b[0], w.batched_launches - b[1])
                                for w, b in zip(wrappers, before)])
                if key == "block":
                    y = out[0].to_local()
                else:
                    ys = [r.to_local() for r in out]
            (ex, block), (ex_rows, each) = counts["block"], counts["rows"]
            assert ex_rows == v.shape[0] * ex
            assert any(n for n, _ in block)
            for (n, lanes), (n_rows, lanes_rows) in zip(block, each):
                assert n == lanes and n_rows == v.shape[0] * n and lanes_rows == 0
            for i in range(v.shape[0]):
                assert torch.equal(y[i], ys[i])
    finally:
        dist.destroy_process_group()


def _bicgstab_64(device, calls=None):
    n = 64
    op = tt.poisson_operator(n)

    def counted(v):
        if calls is not None:
            calls[0] += 1
        return op(v)

    b = tt.as_tensor(np_poisson(np.ones((n, n))), device)
    return tt.bicgstab(counted, b, tol=1e-9,
                       M=tt.chebyshev_preconditioner(counted, 0.2, 8.2))


def test_bicgstab_on_the_card_matches_cpu_and_launches_k1_per_application(cuda_device):
    """cbpr2 BiCGSTAB at 64²: the card's solve against the port's CPU solve
    (the same status, iterations within 2, x to 1e-6), one K1 launch per
    operator application: 4 an iteration (A z1, A z2, the A in each
    cbpr2), the ‖A‖ probe, each residual replacement and the certification
    (the applications are counted by a wrapper around A)."""
    cpu = _bicgstab_64("cpu")
    calls = [0]
    before = tst.stencil5_cuda.launches
    gpu = _bicgstab_64(cuda_device, calls)
    torch.cuda.synchronize()
    launched = tst.stencil5_cuda.launches - before
    assert gpu.status == cpu.status == tt.SolverStatus.CONVERGED
    assert abs(gpu.iterations - cpu.iterations) <= 2
    assert rel_err(gpu.x, cpu.x) <= 1e-6
    assert launched == calls[0] >= 4 * gpu.iterations + 2
    assert gpu.host_syncs == gpu.iterations + 2
    true = np.linalg.norm(np_poisson(np.ones((64, 64)))
                          - np_poisson(gpu.x.cpu().numpy()))
    assert true < 1e-9


def test_lanczos_bounds_on_the_card_match_cpu(cuda_device):
    n = 64
    for rigorous in (True, False):
        cpu = tt.lanczos_bounds(tt.poisson_operator(n), torch.ones((n, n), dtype=torch.float64),
                                20, rigorous)
        before = tst.stencil5_cuda.launches
        gpu = tt.lanczos_bounds(tt.poisson_operator(n),
                                torch.ones((n, n), dtype=torch.float64, device=cuda_device),
                                20, rigorous)
        assert tst.stencil5_cuda.launches - before == 20
        assert gpu[0].device.type == "cuda"
        for g, c in zip(gpu, cpu):
            assert abs(float(g) - float(c)) <= 1e-10 * max(abs(float(c)), 1e-300)


def test_programs_run_on_the_card(cuda_device, tmp_path):
    """The eight programs at smoke sizes on the card (their default
    device): every row converged."""
    import json

    from gmres_tpu_torch.benchmarks.cli import main

    out = str(tmp_path / "rows.jsonl")
    for argv in (["dense-poisson", "--nsize", "8", "--restart", "20", "--tol", "1e-12"],
                 ["hilbert"],
                 ["poisson-mf", "--nsize", "24", "--restart", "20", "--tol", "1e-10"],
                 ["cg", "--grids", "16:24:8", "--tol", "1e-8"],
                 ["bicgstab", "--grids", "16:24:8", "--tol", "1e-8"],
                 ["strong-scaling", "--nsize", "16", "--restart", "10", "--tol", "1e-8"],
                 ["weak-scaling", "--nsize-per-device", "16", "--restart", "10",
                  "--tol", "1e-8"],
                 ["restart-sweep", "--nsize", "16", "--start", "5", "--ntests", "2",
                  "--tol", "1e-8"]):
        main(argv + ["--jsonl", out])
    with open(out) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 2 + 2 + 2 + 2 + 2 + 1 + 1 + 2
    for r in rows:
        assert r["status"] == 0, r


# ---------------------------------------------------------------------------
# Convection-diffusion (BASELINE config 3): K1 and K2 at the cycle's
# coefficients, the cycle and the convdiff program on the card.
# ---------------------------------------------------------------------------


def _upwind_coarse_coefs(n_fine=1024, n=16):
    """The upwind coefficients of the convdiff cycle's level of size n under
    a fine grid of n_fine at γ = (0.4, 0.2): γ doubles per coarsening."""
    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_coefs_upwind

    scale = n_fine // n
    return convection_diffusion_coefs_upwind(0.4 * scale, 0.2 * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,order", [(16, 3), (16, 64), (64, 3), (64, 64)])
def test_k2_jacobi_upwind_coefficients_bitwise_to_sweep_path(cuda_device, dtype, n, order):
    """Damped Jacobi (jacobi_k_scalars) on the upwind coarse-level stencil,
    where c₀ = 4 + 2|γx| + 2|γy| reaches 80.8: every path that can take the
    grid, and the routed call, give the per-sweep path's bits."""
    coefs = _upwind_coarse_coefs(n=n)
    theta, steps = tfu.jacobi_k_scalars(0.7, coefs[0], order)
    r = to_torch(seeded(58, (n, n)), cuda_device).to(dtype)
    ref = tfu.chebk_cuda(r, theta, steps, coefs, _path=("sweep", None))
    paths = _k2_forced_paths(r, order - 1)
    assert paths
    for path in paths:
        torch.testing.assert_close(tfu.chebk_cuda(r, theta, steps, coefs, _path=path),
                                   ref, rtol=0, atol=0, msg=f"{path}")
    before = tfu.chebk_cuda.launches
    z = tfu.poly_stencil_smoother_pallas(r, theta, steps, coefs)
    torch.cuda.synchronize()
    assert tfu.chebk_cuda.launches > before
    torch.testing.assert_close(z, ref, rtol=0, atol=0)
    assert rel_err(z, tfu.poly_stencil_smoother_plain(r, theta, steps, coefs)) < (
        1e-5 if dtype == torch.float32 else 1e-12)


def _no_plain_versions(monkeypatch):
    """Make every plain version the convdiff cycle could reach on the card
    raise: a CUDA tensor must take a kernel, never quietly a plain route."""
    from gmres_tpu_torch.precond import multigrid as tmg

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((tst, "stencil_5pt_general"), (tst, "residual_restrict_plain"),
                      (tst, "correct_residual_plain"), (tfu, "poly_stencil_smoother_plain"),
                      (tmg, "stencil_5pt_general")):
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("smoother,gamma", [("jacobi", (0.4, 0.2)), ("chebyshev", (0.4, 0.2)),
                                            ("auto", (0.4, 0.2)), ("rbgs", (0.4, 0.2)),
                                            ("rbgs", (2.0, 1.0)), ("auto", (2.0, 1.0))])
def test_convdiff_cycle_on_the_card_matches_cpu(cuda_device, monkeypatch, dtype, rtol,
                                                smoother, gamma):
    """The convdiff cycle at 64² on the card against its CPU route (JAX's
    CPU arithmetic): K1 for the level operators and both V-cycle forms, K2
    for the Jacobi and Chebyshev smoothers and the coarse solve (K2's r/θ
    start rounds differently from the CPU loop's step·r, so the stated
    tolerance), no plain version on the card."""
    n = 64
    m = tt.convection_diffusion_multigrid_preconditioner(n, *gamma, smoother=smoother)
    r = to_torch(seeded(59, (n, n))).to(dtype)
    z_cpu = m(r)
    _no_plain_versions(monkeypatch)
    counters = (tst.stencil5_cuda, tst.residual_restrict_cuda, tst.correct_residual_cuda,
                tfu.chebk_cuda)
    before = [c.launches for c in counters]
    z = m(r.to(cuda_device))
    torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(counters, before)]
    assert z.dtype == dtype and z.device.type == "cuda"
    assert rel_err(z, z_cpu) <= rtol
    assert launched[1] == launched[2] == m.levels - 1
    if "rbgs" in m.smoothers:
        assert launched[0] > 0
    if set(m.smoothers) != {"rbgs"}:
        assert launched[3] > 0


def test_convdiff_operator_launches_k1(cuda_device, monkeypatch):
    n = 64
    x = to_torch(seeded(60, (n, n)), cuda_device)
    y_cpu = tt.convection_diffusion_apply(x.cpu())
    _no_plain_versions(monkeypatch)
    before = tst.stencil5_cuda.launches
    y = tt.convection_diffusion_operator(n)(x)
    yf = tt.convection_diffusion_apply(x.reshape(-1))
    torch.cuda.synchronize()
    assert tst.stencil5_cuda.launches == before + 2
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=0, atol=0)
    torch.testing.assert_close(yf.cpu(), y_cpu.reshape(-1), rtol=0, atol=0)


def test_convdiff_program_on_the_card_matches_cpu(cuda_device, tmp_path):
    """``convdiff --solver bicgstab --precond mg`` at 64² on the card (its
    default device) against ``--device cpu``: both converge, iterations
    within 2; the card's run launches K1, its two forms and K2."""
    import json

    from gmres_tpu_torch.benchmarks.cli import main

    rows = {}
    for where in ("cuda", "cpu"):
        out = str(tmp_path / f"{where}.jsonl")
        before = [c.launches for c in (tst.stencil5_cuda, tst.residual_restrict_cuda,
                                       tst.correct_residual_cuda, tfu.chebk_cuda)]
        main(["convdiff", "--nsize", "64", "--precond", "mg", "--device", where,
              "--jsonl", out])
        after = [c.launches for c in (tst.stencil5_cuda, tst.residual_restrict_cuda,
                                      tst.correct_residual_cuda, tfu.chebk_cuda)]
        if where == "cuda":
            assert all(a > b for a, b in zip(after, before))
        else:
            assert after == before
        with open(out) as f:
            rows[where] = json.loads(f.readline())
    assert rows["cuda"]["status"] == rows["cpu"]["status"] == 0
    assert abs(rows["cuda"]["iterations"] - rows["cpu"]["iterations"]) <= 2
    assert rows["cuda"]["residual"] < 1e-9


def _family_solve(name, where):
    """One solve of the GMRES family at 64² (lgmres and gmres_dr on Poisson
    with cbpr2 on the right, idrs on convection-diffusion with its cycle)."""
    n = 64
    if name == "idrs":
        op = tt.convection_diffusion_operator(n, 0.4, 0.2)
        m = tt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
    else:
        op = tt.poisson_operator(n)
        m = tt.chebyshev_preconditioner(op, 0.2, 8.2)
    b = op(torch.ones((n, n), dtype=torch.float64, device=where))
    if name == "lgmres":
        return tt.lgmres(op, b, restart=10, aug=3, tol=1e-10, M=m)
    if name == "gmres_dr":
        return tt.gmres_dr(op, b, restart=16, deflate=4, tol=1e-10, M=m)
    return tt.idrs(op, b, s=4, tol=1e-9, M=m)


@pytest.mark.parametrize("name", ["lgmres", "gmres_dr", "idrs"])
def test_gmres_family_on_the_card_matches_cpu(cuda_device, monkeypatch, name):
    """The solve on the card, with every plain version made to raise, against
    the same solve on the CPU (the plain versions): both converge, the
    counts within 2, x within 1e-8; K1 (and for idrs' cycle K2) launched."""
    cpu = _family_solve(name, "cpu")
    _no_plain_versions(monkeypatch)
    before = (tst.stencil5_cuda.launches, tfu.chebk_cuda.launches)
    card = _family_solve(name, cuda_device)
    torch.cuda.synchronize()
    k1, k2 = (tst.stencil5_cuda.launches - before[0], tfu.chebk_cuda.launches - before[1])
    assert card.status == cpu.status == 0
    assert abs(card.iterations - cpu.iterations) <= 2
    assert abs(getattr(card, "restarts", 0) - getattr(cpu, "restarts", 0)) <= 2
    assert card.x.device.type == "cuda" and rel_err(card.x.cpu(), cpu.x) < 1e-8
    assert k1 > 0 and (k2 > 0) == (name == "idrs")


def _batched_counts():
    """Launches on a (lanes, rows, cols) block, by kernel (each also in
    ``_kernel_counts``)."""
    return {"K1": tst.stencil5_cuda.batched_launches,
            "K1rr": tst.residual_restrict_cuda.batched_launches,
            "K1cr": tst.correct_residual_cuda.batched_launches,
            "K2": tfu.chebk_cuda.batched_launches}


def _counted(fn, calls, key):
    """fn, counting its calls in calls[key]: under row_apply's vmap, one a
    block application."""
    def apply(v):
        calls[key] += 1
        return fn(v)

    apply.__wrapped__ = fn
    return apply


def _block_launches(solve, op, m, v):
    """(per-vector launches of m, applications {"A", "M"}, single-grid and
    batched launches of the block solve) for ``solve(A, M)``."""
    before = _kernel_counts()
    m(v)
    torch.cuda.synchronize()
    per_m = {key: c - before[key] for key, c in _kernel_counts().items()}
    calls = {"A": 0, "M": 0}
    every, batched = _kernel_counts(), _batched_counts()
    res = solve(_counted(op, calls, "A"), _counted(m, calls, "M"))
    torch.cuda.synchronize()
    batched = {key: c - batched[key] for key, c in _batched_counts().items()}
    single = {key: c - every[key] - batched[key] for key, c in _kernel_counts().items()}
    return res, per_m, calls, single, batched


def test_block_gmres_launches_k1_once_per_row(cuda_device):
    """A block application of A (and of the V-cycle) is one batched launch
    of each of its kernels for all rows of the block (row_apply's vmap
    through the kernels' vmap rules, as JAX batches the rows with vmap): the
    batched launches per block application are the launches per vector, and
    no single-grid launch is made."""
    n, s = 128, 4
    op = tt.poisson_operator(n)
    m = tt.poisson_multigrid_preconditioner(n)
    v = to_torch(seeded(61, (n, n)), cuda_device)
    b = torch.stack([op(to_torch(seeded(62 + i, (n, n)), cuda_device)) for i in range(s)])
    res, per_m, calls, single, batched = _block_launches(
        lambda a, mm: tt.block_gmres(a, b, restart=5, tol=1e-30, max_restarts=1, M=mm),
        op, m, v)
    assert res.restarts == 1 and res.x.device.type == "cuda"
    # Two residual blocks, 5 steps of M then A, the update's M.
    assert calls == {"A": 2 + 5, "M": 5 + 1}
    assert all(c == 0 for c in single.values())
    for key in ("K2", "K1rr", "K1cr"):
        assert batched[key] == calls["M"] * per_m[key]
    assert batched["K1"] == calls["M"] * per_m["K1"] + calls["A"]


def _short_solve(name, dev):
    """One solve of the short-recurrence family or the real models at a small
    size, float64, on ``dev``."""
    n = 64
    ones = torch.ones((n, n), dtype=torch.float64, device=dev)
    if name in ("block_cg", "minres", "sstep_cg", "chebyshev_solve"):
        op = tt.poisson_operator(n)
        m = tt.poisson_multigrid_preconditioner(n)
        b = op(ones)
    if name == "block_cg":
        bs = torch.stack([op(to_torch(seeded(64 + i, (n, n)), dev)) for i in range(3)])
        return tt.block_cg(op, bs, tol=1e-9, M=m)
    if name == "minres":
        return tt.minres(op, b, tol=1e-9, M=m)
    if name == "sstep_cg":
        return tt.sstep_cg(op, b, s=4, tol=1e-9, M=m)
    if name == "chebyshev_solve":
        lo, hi = tt.poisson_spectral_bounds(n)
        return tt.chebyshev_solve(op, b, lo, hi, order=16, tol=1e-9, coefs=tst.POISSON_COEFS)
    if name == "anisotropic":
        op = tt.anisotropic_operator(n, 0.01)
        return tt.cg(op, op(ones), tol=1e-9, M=tt.anisotropic_multigrid_preconditioner(n, 0.01))
    if name == "poisson3d":
        op = tt.poisson3d_operator(16)
        b = op(torch.ones((16, 16, 16), dtype=torch.float64, device=dev))
        return tt.cg(op, b, tol=1e-9, M=tt.poisson3d_multigrid_preconditioner(16))
    c = np.ones((n, n))
    c[10:26, 10:26] = 1e5
    w = np.zeros((1, n, n))
    w[0, 10:26, 10:26] = 1.0 / 16.0
    c_t = to_torch(c, dev)
    op = tt.varcoef_operator(c_t)
    m = tt.coarse_space_preconditioner(op, to_torch(w, dev),
                                       M=tt.varcoef_multigrid_preconditioner(c_t))
    b = op(to_torch(seeded(65, (n, n)), dev))
    return tt.cg(op, b, tol=1e-9 * float(torch.linalg.norm(b)), M=m)


@pytest.mark.parametrize("name", ["block_cg", "minres", "sstep_cg", "chebyshev_solve",
                                  "anisotropic", "poisson3d", "varcoef"])
def test_short_family_on_the_card_matches_cpu(cuda_device, monkeypatch, name):
    """The solve on the card, with every 5-point plain version made to raise,
    against the same solve on the CPU: both converge, the counts within 2, x
    within 1e-8; K1 launched where the path has a 5-point stencil (the 3-D
    and variable-coefficient paths are plain PyTorch, as in gmres_tpu)."""
    cpu = _short_solve(name, "cpu")
    _no_plain_versions(monkeypatch)
    before = _kernel_counts()
    card = _short_solve(name, cuda_device)
    torch.cuda.synchronize()
    k1, k2 = (_kernel_counts()[k] - before[k] for k in ("K1", "K2"))
    assert card.status == cpu.status == 0
    assert abs(card.iterations - cpu.iterations) <= 2
    assert card.x.device.type == "cuda" and rel_err(card.x.cpu(), cpu.x) < 1e-8
    assert (k1 > 0) == (name not in ("poisson3d", "varcoef"))
    assert (k2 > 0) == (name in ("block_cg", "minres", "sstep_cg", "chebyshev_solve"))


def test_block_cg_launches_k1_once_per_row(cuda_device):
    """A block application of A (and of the V-cycle) is one batched launch
    of each of its kernels for all s rows: 2 iterations of block CG at
    s = 4 launch, per A and M application, the single-vector kernels once."""
    n, s, its = 128, 4, 2
    op = tt.poisson_operator(n)
    m = tt.poisson_multigrid_preconditioner(n)
    v = to_torch(seeded(66, (n, n)), cuda_device)
    b = torch.stack([op(to_torch(seeded(67 + i, (n, n)), cuda_device)) for i in range(s)])
    res, per_m, calls, single, batched = _block_launches(
        lambda a, mm: tt.block_cg(a, b, tol=1e-30, max_iterations=its, M=mm), op, m, v)
    assert res.iterations == its and res.x.device.type == "cuda"
    # The first M and one a step; one A a step and the certification's.
    assert calls == {"A": its + 1, "M": its + 1}
    assert all(c == 0 for c in single.values())
    for key in ("K2", "K1rr", "K1cr"):
        assert batched[key] == calls["M"] * per_m[key]
    assert batched["K1"] == calls["M"] * per_m["K1"] + calls["A"]


def test_chebyshev_solve_launches_k2_once_a_cycle(cuda_device):
    """With coefs, a cycle is one K2 launch (the order-16 polynomial, on
    K2's cluster path at 64²) and one K1 launch (the residual)."""
    n = 64
    op = tt.poisson_operator(n)
    b = op(torch.ones((n, n), dtype=torch.float64, device=cuda_device))
    lo, hi = tt.poisson_spectral_bounds(n)
    before = (tst.stencil5_cuda.launches, tfu.chebk_cuda.launches)
    res = tt.chebyshev_solve(op, b, lo, hi, order=16, tol=1e-9, coefs=tst.POISSON_COEFS)
    torch.cuda.synchronize()
    assert res.converged
    assert tst.stencil5_cuda.launches - before[0] == res.iterations
    assert tfu.chebk_cuda.launches - before[1] == res.iterations


def test_anisotropic_operator_is_k1(cuda_device):
    """The anisotropic operator on the card is one K1 launch with the
    coefficients (2ε + 2, −1, −1, −ε, −ε), equal to the CPU's pad-and-sum
    form within 1e-14 (a different summation order)."""
    x = to_torch(seeded(68, (256, 256)), cuda_device)
    before = tst.stencil5_cuda.launches
    y = tt.anisotropic_apply(x, 0.01)
    torch.cuda.synchronize()
    assert tst.stencil5_cuda.launches == before + 1
    torch.testing.assert_close(y.cpu(), tt.anisotropic_apply(x.cpu(), 0.01), rtol=0,
                               atol=1e-14)


# ---------------------------------------------------------------------------
# K1's autograd and torch.func rules (ops/stencil.py:Stencil5Grid), and the
# solvers that reach them: Helmholtz, QMR/LSQR/LSMR, Newton-Krylov,
# implicit_solve.
# ---------------------------------------------------------------------------

CONVDIFF = (4.0, -1.4, -0.6, -1.2, -0.8)  # convection_diffusion_coefs(0.4, 0.2)
RULE_TOL = {torch.float64: 1e-13, torch.float32: 2e-5}


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("coefs", [tst.POISSON_COEFS, CONVDIFF], ids=["poisson", "convdiff"])
def test_k1_backward_is_one_mirrored_launch(cuda_device, dtype, coefs):
    """torch.func.vjp through K1: the primal is one launch, each pullback
    one more (the stencil with west↔east, south↔north), equal to the plain
    stencil's autograd on the card; the adjoint identity holds."""
    n = 1024
    x = to_torch(seeded(70, (n, n)), cuda_device).to(dtype)
    y = to_torch(seeded(71, (n, n)), cuda_device).to(dtype)
    before = tst.stencil5_cuda.launches
    ax, pull = torch.func.vjp(lambda v: tst.stencil_5pt_pallas(v, coefs), x)
    (aty,) = pull(y)
    (aty2,) = pull(y)
    torch.cuda.synchronize()
    assert tst.stencil5_cuda.launches == before + 3
    _, pull_p = torch.func.vjp(lambda v: tst.stencil_5pt_general(v, *coefs), x)
    assert _rel(aty, pull_p(y)[0]) <= RULE_TOL[dtype]
    assert torch.equal(aty, aty2)
    # ⟨A x, y⟩ = ⟨x, Aᵀ y⟩, relative to ‖A x‖‖y‖.
    lhs = torch.sum(ax.double() * y.double())
    rhs = torch.sum(x.double() * aty.double())
    scale = torch.linalg.norm(ax.double()) * torch.linalg.norm(y.double())
    assert float((lhs - rhs).abs() / scale) <= RULE_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k1_jvp_is_one_launch(cuda_device, dtype):
    n = 1024
    x = to_torch(seeded(72, (n, n)), cuda_device).to(dtype)
    t = to_torch(seeded(73, (n, n)), cuda_device).to(dtype)
    before = (tst.stencil5_cuda.launches, dict(tst.Stencil5Grid.rule_applications))
    _, jv = torch.func.jvp(lambda v: tst.stencil_5pt_pallas(v, CONVDIFF), (x,), (t,))
    torch.cuda.synchronize()
    assert tst.stencil5_cuda.launches == before[0] + 2  # primal and tangent
    assert tst.Stencil5Grid.rule_applications["tangent"] == before[1]["tangent"] + 1
    _, jv_p = torch.func.jvp(lambda v: tst.stencil_5pt_general(v, *CONVDIFF), (x,), (t,))
    assert _rel(jv, jv_p) <= RULE_TOL[dtype]


def test_k1_coefficient_gradient_matches_plain(cuda_device):
    """A tensor coefficient keeps its gradient on the card: Σ ȳ·shiftₖ(x),
    against the plain stencil's autograd; the launch is the primal only."""
    n = 512
    x = to_torch(seeded(74, (n, n)), cuda_device)
    g = to_torch(seeded(75, (n, n)), cuda_device)
    c_k = torch.tensor(CONVDIFF, dtype=torch.float64, device=cuda_device, requires_grad=True)
    c_p = torch.tensor(CONVDIFF, dtype=torch.float64, device=cuda_device, requires_grad=True)
    before = tst.stencil5_cuda.launches
    (gk,) = torch.autograd.grad(torch.sum(tst.stencil_5pt_pallas(x, c_k) * g), c_k)
    torch.cuda.synchronize()
    assert tst.stencil5_cuda.launches == before + 1
    (gp,) = torch.autograd.grad(torch.sum(tst.stencil_5pt_general(x, *c_p.unbind()) * g), c_p)
    torch.testing.assert_close(gk, gp, rtol=1e-12, atol=0)


def test_kernels_without_rules_refuse_transforms(cuda_device):
    """K2, K1's halo form, K1rr, K1cr, K3, K5, K6 and K7 raise a named error
    under autograd or torch.func, before any launch, for a tracked operand
    and for a tracked stencil coefficient alike (the launch reads its value
    and would drop its gradient)."""
    n = 64
    r = to_torch(seeded(76, (n, n)), cuda_device)
    tracked = r.clone().requires_grad_()
    c = torch.tensor(CONVDIFF, dtype=torch.float64, device=cuda_device, requires_grad=True)
    theta, _, steps = tfu.chebyshev_k_scalars(0.5, 8.0, 3)
    dia = tt.sparse_operator(tt.poisson_dia(n, device=cuda_device))
    counters = (tst.stencil5_cuda, tst.residual_restrict_cuda, tst.correct_residual_cuda,
                tfu.chebk_cuda, tsp.dia_spmv_cuda, tfu.cheb2_cuda, tst.stencil5_dd_cuda,
                tfu.axpy_dot_cuda)
    before = [k.launches for k in counters]
    calls = {
        "K2": lambda: torch.func.vjp(lambda v: tfu.chebk_cuda(v, theta, steps), r),
        "K1": lambda: tst.stencil5_cuda(tracked, r[0], None),
        "K1rr": lambda: tst.residual_restrict_cuda(tracked, r),
        "K1cr": lambda: torch.func.jvp(lambda e: tst.correct_residual_cuda(r, e, r[:32, :32])[1],
                                       (r,), (r,)),
        "K3": lambda: torch.func.vjp(dia, r.reshape(-1)),
        "K5": lambda: tfu.cheb2_cuda(tracked, None, None, 4.2, 0.2),
        "K7b": lambda: tfu.axpy_dot_cuda(0.5, tracked, r, r),
    }
    coef_calls = {
        "K1": lambda: tst.stencil_5pt_pallas_halo(r, r[0], None, c),
        "K1rr": lambda: tst.residual_restrict(r, r, c),
        "K1cr": lambda: tst.correct_residual(r, r, r[:32, :32].contiguous(), c),
        "K2": lambda: tfu.poly_stencil_smoother_pallas(r, theta, steps, c),
        "K5": lambda: tfu.chebyshev_poisson_fused(r, None, None, 4.2, 0.2, c),
        "K6": lambda: tst.stencil_5pt_dd_general_pallas_blocked(r.float(), r.float(), c),
    }
    for kernel, call in [*calls.items(), *coef_calls.items()]:
        with pytest.raises(RuntimeError, match=f"kernel {kernel} .*ROADMAP: transposes of K2–K8"):
            call()
    with pytest.raises(RuntimeError, match="kernel K1 .*torch.func transform"):
        torch.func.grad(lambda cv: tst.stencil_5pt_pallas_halo(r, r[0], None, cv).sum())(
            c.detach())
    torch.cuda.synchronize()
    assert [k.launches for k in counters] == before


def test_k1_full_grid_takes_the_function_only_when_tracked(cuda_device):
    """stencil_5pt_pallas launches the wrapper directly where nothing
    tracks x or a coefficient (no grad_fn, no rule applied), and through
    Stencil5Grid where autograd does; the bits are the same."""
    x = to_torch(seeded(77, (256, 256)), cuda_device)
    before = (tst.stencil5_cuda.launches, dict(tst.Stencil5Grid.rule_applications))
    y = tst.stencil_5pt_pallas(x, CONVDIFF)
    xt = x.clone().requires_grad_()
    yt = tst.stencil_5pt_pallas(xt, CONVDIFF)
    torch.cuda.synchronize()
    assert y.grad_fn is None and yt.grad_fn is not None
    assert torch.equal(y, yt.detach())
    assert tst.stencil5_cuda.launches == before[0] + 2
    assert tst.Stencil5Grid.rule_applications == before[1]


def test_qmr_on_the_card_launches_k1_twice_an_iteration(cuda_device):
    """QMR on convdiff: Aᵀ is the pullback of torch.func.vjp through K1. K1
    launches once for the vjp's primal, twice an iteration (A p, Aᵀ q) and
    once for the certification; the count and x are the CPU's."""
    n = 32
    op = tt.convection_diffusion_operator(n, 0.4, 0.2)
    b = op(torch.ones((n, n), dtype=torch.float64, device=cuda_device))
    before = (tst.stencil5_cuda.launches, dict(tst.Stencil5Grid.rule_applications))
    res = tt.qmr(op, b, tol=1e-9, max_iterations=3000)
    torch.cuda.synchronize()
    assert res.converged
    launched = tst.stencil5_cuda.launches - before[0]
    assert launched == 1 + 2 * res.iterations + 1
    assert tst.Stencil5Grid.rule_applications["transpose"] - before[1]["transpose"] == \
        res.iterations
    cpu = tt.qmr(op, b.cpu(), tol=1e-9, max_iterations=3000)
    assert abs(cpu.iterations - res.iterations) <= max(2, 0.05 * cpu.iterations)
    torch.testing.assert_close(res.x.cpu(), cpu.x, rtol=0, atol=1e-6)


def test_qmr_with_a_cycle_and_no_mt_raises_on_the_card(cuda_device):
    """Deriving (M∘A)ᵀ through the multigrid cycle reaches K2 under
    torch.func.vjp: a named error on the card (the CPU derives it from the
    plain cycle; tests/test_torch_transpose_solvers.py)."""
    n = 64
    op = tt.convection_diffusion_operator(n, 0.4, 0.2)
    b = op(torch.ones((n, n), dtype=torch.float64, device=cuda_device))
    m = tt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
    with pytest.raises(RuntimeError, match="ROADMAP: transposes of K2–K8"):
        tt.qmr(op, b, tol=1e-8, M=m)
    mt = tt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2, transpose=True)
    assert tt.qmr(op, b, tol=1e-8, M=m, MT=mt).converged


@pytest.mark.parametrize("name", ["lsqr", "lsmr"])
def test_least_squares_on_the_card_match_cpu(cuda_device, name):
    n = 24
    op = tt.convection_diffusion_operator(n, 0.4, 0.2)
    b = op(torch.ones((n, n), dtype=torch.float64, device=cuda_device))
    before = tst.stencil5_cuda.launches
    res = getattr(tt, name)(op, b, tol=1e-9)
    torch.cuda.synchronize()
    # The vjp's primal and the first Aᵀ u, A and Aᵀ an iteration, A and Aᵀ at
    # the certification.
    assert tst.stencil5_cuda.launches - before == 2 + 2 * res.iterations + 2
    cpu = getattr(tt, name)(op, b.cpu(), tol=1e-9)
    assert res.converged and abs(cpu.iterations - res.iterations) <= 2


def test_newton_krylov_on_the_card_two_k1_a_jv(cuda_device):
    """J·v = torch.func.jvp of the Bratu residual: one K1 for the primal,
    one for the tangent; Newton and inner counts are the CPU's."""
    n = 64
    F = tt.bratu_residual(n, 6.0)
    x0 = torch.zeros((n, n), dtype=torch.float64, device=cuda_device)
    calls = [0]

    def Fc(u):
        calls[0] += 1
        return F(u)

    before = (tst.stencil5_cuda.launches, dict(tst.Stencil5Grid.rule_applications))
    res = tt.newton_krylov(Fc, x0, tol=1e-10, M=tt.poisson_multigrid_preconditioner(n))
    torch.cuda.synchronize()
    assert res.converged
    tangents = tst.Stencil5Grid.rule_applications["tangent"] - before[1]["tangent"]
    assert tangents == res.jv_products
    assert tst.stencil5_cuda.launches - before[0] == calls[0] + res.jv_products
    cpu = tt.newton_krylov(F, x0.cpu(), tol=1e-10, M=tt.poisson_multigrid_preconditioner(n))
    assert (cpu.iterations, cpu.inner_iterations) == (res.iterations, res.inner_iterations)
    torch.testing.assert_close(res.x.cpu(), cpu.x, rtol=0, atol=1e-10)


def test_implicit_gradient_on_the_card_matches_central_differences(cuda_device):
    """A(γ) the convdiff operator with γ a tensor: the θ pullback reaches
    K1's coefficient rule, the adjoint solve K1's backward rule."""
    import functools

    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_apply

    n = 32
    b = to_torch(seeded(77, (n, n)), cuda_device)
    target = to_torch(seeded(78, (n, n)), cuda_device)
    solve = functools.partial(tt.gmres, restart=30, tol=1e-12, max_restarts=200,
                              compute_v_err=False)

    def loss(gm):
        x = tt.implicit_solve(lambda g: (lambda v: convection_diffusion_apply(v, g, 0.2)),
                              gm, b, solver=solve)
        return torch.sum((x - target) ** 2)

    g0 = torch.tensor(0.35, dtype=torch.float64, device=cuda_device, requires_grad=True)
    before = tst.Stencil5Grid.rule_applications["transpose"]
    (g,) = torch.autograd.grad(loss(g0), g0)
    assert tst.Stencil5Grid.rule_applications["transpose"] > before
    eps = 1e-6
    with torch.no_grad():
        fd = (loss(g0.detach() + eps) - loss(g0.detach() - eps)) / (2 * eps)
    assert abs(float(g) - float(fd)) <= 1e-5 * abs(float(fd))


def test_helmholtz_on_the_card_matches_cpu(cuda_device):
    """The SPD cycle (K2 smoothers, K1's V-cycle forms) and the split CSL
    cycle (K1 neighbour stencils) on the card against their CPU versions;
    MINRES's count within 2 of the CPU's."""
    n = 64
    kh2 = 10.0 * tt.helmholtz_lambda_min(n)
    r = to_torch(seeded(79, (n, n)), cuda_device)
    m = tt.helmholtz_shifted_laplacian_preconditioner(n, kh2)
    before = (tst.stencil5_cuda.launches, tfu.chebk_cuda.launches,
              tst.residual_restrict_cuda.launches)
    z = m(r)
    torch.cuda.synchronize()
    assert tfu.chebk_cuda.launches > before[1] and tst.residual_restrict_cuda.launches > before[2]
    assert _rel(z.cpu(), m(r.cpu())) <= 1e-12
    csl = tt.csl_multigrid_preconditioner(n, kh2, layout="split")
    u = torch.stack([r, 2 * r])
    before = tst.stencil5_cuda.launches
    zc = csl(u)
    torch.cuda.synchronize()
    assert tst.stencil5_cuda.launches > before
    assert _rel(zc.cpu(), csl(u.cpu())) <= 1e-12
    op = tt.helmholtz_operator(n, kh2)
    b = op(torch.ones((n, n), dtype=torch.float64, device=cuda_device))
    res = tt.minres(op, b, tol=1e-9, M=m)
    cpu = tt.minres(op, b.cpu(), tol=1e-9, M=m)
    assert res.converged and abs(res.iterations - cpu.iterations) <= 2


def _kernel_counts():
    """Every launch (on a grid or a block), by kernel."""
    return {"K1": tst.stencil5_cuda.launches, "K1rr": tst.residual_restrict_cuda.launches,
            "K1cr": tst.correct_residual_cuda.launches, "K2": tfu.chebk_cuda.launches}


def _spectral_solve(name, dev):
    """One solve of the eigensolvers and matrix functions at a small size,
    float64, on ``dev``."""
    n = 32
    gen = torch.Generator(device="cpu").manual_seed(5)
    probe = torch.randn((n, n), generator=gen, dtype=torch.float64).to(dev)
    # Moderate convection: well-conditioned eigenvalues (at γ = (2, 0.5) a
    # 1e-9 residual leaves ~1e-7 of eigenvalue error on either device).
    cd = tt.convection_diffusion_operator(n, 0.4, 0.2)
    if name == "lobpcg":
        x0 = torch.randn((3, n, n), generator=gen, dtype=torch.float64).to(dev)
        return tt.lobpcg(tt.poisson_operator(n), x0, tol=1e-9,
                         M=tt.poisson_multigrid_preconditioner(n))
    if name == "arnoldi_eigs":
        return tt.arnoldi_eigs(cd, probe, nev=4, steps=30, tol=1e-10)
    if name == "arnoldi_eigs_real":
        return tt.arnoldi_eigs_real(cd, probe, nev=4, steps=30, tol=1e-10)
    if name == "theta_evolve":
        m = tt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2, shift=2.0)
        return tt.theta_evolve(cd, probe, dt=1.0, n_steps=3, solver="gcrodr", tol=1e-9,
                               M=lambda r: m(r) / 0.5)
    return tt.trace_funm(tt.poisson_operator(n), torch.log, probe, n_probes=4, steps=20)


@pytest.mark.parametrize("name", ["lobpcg", "arnoldi_eigs", "arnoldi_eigs_real",
                                  "theta_evolve", "trace_funm"])
def test_spectral_on_the_card_matches_cpu(cuda_device, monkeypatch, name):
    """The card's eigenvalues (or trajectory, or log-det) equal the CPU
    port's within 1e-10 relative, with every 5-point plain version made to
    raise; K1 launched always, and LOBPCG with the V-cycle and the shifted
    convdiff cycle of theta_evolve also launch K1's forms and K2."""
    cpu = _spectral_solve(name, "cpu")
    _no_plain_versions(monkeypatch)
    before = _kernel_counts()
    card = _spectral_solve(name, cuda_device)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _kernel_counts().items()}
    if name == "trace_funm":
        assert rel_err(card.samples.cpu(), cpu.samples) < 1e-10
    elif name == "theta_evolve":
        assert card.status == cpu.status == 0
        assert rel_err(card.u.cpu(), cpu.u) < 1e-10
    else:
        assert card.status == cpu.status == 0
        lam, lam_cpu = card.eigenvalues.cpu().numpy(), cpu.eigenvalues.numpy()
        keyed = [np.sort_complex(v.real + 1j * np.abs(v.imag)) for v in (lam, lam_cpu)]
        assert np.max(np.abs(keyed[0] - keyed[1])) < 1e-10 * np.max(np.abs(lam_cpu))
    assert launched["K1"] > 0
    forms = launched["K1rr"] > 0 and launched["K1cr"] > 0 and launched["K2"] > 0
    assert forms == (name in ("lobpcg", "theta_evolve"))


def test_arnoldi_eigs_two_k1_a_complex_matvec(cuda_device, monkeypatch):
    """A real operator under the complex basis: each complex matvec is two
    K1 launches on contiguous real parts, and no plain stencil runs; the
    certification's block of nev vectors is one block application (two
    batched launches)."""
    n, steps = 64, 20
    _no_plain_versions(monkeypatch)
    op = tt.convection_diffusion_operator(n, 2.0, 0.5)
    calls = []

    def counted(v):
        calls.append(not v.is_complex() and (tt.ops._cuda.vmapped(v) or v.is_contiguous()))
        return op(v)

    probe = to_torch(seeded(70, (n, n)), cuda_device)
    before = (tst.stencil5_cuda.launches, tst.stencil5_cuda.batched_launches)
    res = tt.arnoldi_eigs(counted, probe, nev=2, steps=steps, tol=1e-30, max_restarts=1)
    torch.cuda.synchronize()
    # steps matvecs of the one cycle and one block application of nev rows.
    assert res.iterations == 1 and len(calls) == 2 * (steps + 1) and all(calls)
    assert tst.stencil5_cuda.launches - before[0] == 2 * steps + 2
    assert tst.stencil5_cuda.batched_launches - before[1] == 2


def test_lobpcg_with_mg_launches_each_row(cuda_device, monkeypatch):
    """An LOBPCG iteration applies A to one block of 3k rows and M to one
    block of k rows (the first Rayleigh–Ritz A to k rows): each block
    application is one batched launch of each kernel for all its rows, so
    the launches of two iterations are the block applications times one
    vector's."""
    from gmres_tpu_torch.solvers import lobpcg as lobpcg_mod
    from gmres_tpu_torch.solvers import requests

    n, k, its = 128, 2, 2
    op = tt.poisson_operator(n)
    m = tt.poisson_multigrid_preconditioner(n)
    v = to_torch(seeded(71, (n, n)), cuda_device)
    x0 = to_torch(seeded(72, (k, n, n)), cuda_device)
    rows = {"A": [], "M": []}

    def rows_of(fn):
        # LOBPCG's block applications are requests on requests.rows(fn).
        on_rows = requests.rows(fn)

        def apply(block):
            rows["A" if fn.__wrapped__ is op else "M"].append(block.shape[0])
            return on_rows(block)

        return apply

    monkeypatch.setattr(lobpcg_mod, "rows", rows_of)
    res, per_m, calls, single, batched = _block_launches(
        lambda a, mm: tt.lobpcg(a, x0, tol=0.0, max_iterations=its, M=mm), op, m, v)
    assert res.iterations == its
    assert calls == {"A": 1 + its, "M": its}
    assert rows == {"A": [k] + [3 * k] * its, "M": [k] * its}
    assert all(c == 0 for c in single.values())
    for key in ("K2", "K1rr", "K1cr"):
        assert batched[key] == calls["M"] * per_m[key]
    assert batched["K1"] == calls["M"] * per_m["K1"] + calls["A"]


def test_nystrom_on_the_card_matches_cpu(cuda_device, monkeypatch):
    """The Nyström preconditioner built on the card from the same sketch as
    on the CPU: λ̂ and M r − r (what the preconditioner changes, ~1% of r on
    Poisson) equal the CPU port's within 1e-10 relative; the sketch's 2·rank
    matvecs, two block applications of rank rows, are two batched K1
    launches, and no plain stencil runs."""
    n, rank = 64, 16
    cpu_m, cpu_lam = tt.nystrom_preconditioner(
        tt.poisson_operator(n), torch.zeros((n, n), dtype=torch.float64), rank=rank)
    _no_plain_versions(monkeypatch)
    before = (tst.stencil5_cuda.launches, tst.stencil5_cuda.batched_launches)
    m, lam = tt.nystrom_preconditioner(
        tt.poisson_operator(n), torch.zeros((n, n), dtype=torch.float64, device=cuda_device),
        rank=rank)
    torch.cuda.synchronize()
    assert tst.stencil5_cuda.launches - before[0] == 2
    assert tst.stencil5_cuda.batched_launches - before[1] == 2
    assert rel_err(lam.cpu(), cpu_lam) < 1e-10
    r = seeded(73, (n, n))
    dm = m(to_torch(r, cuda_device)).cpu() - to_torch(r)
    dm_cpu = cpu_m(to_torch(r)) - to_torch(r)
    assert float(torch.linalg.norm(dm_cpu)) > 1e-4 * float(np.linalg.norm(r))
    assert rel_err(dm, dm_cpu) < 1e-10


def test_spai_on_the_card_matches_cpu(cuda_device):
    """SPAI from a CSR matrix on the card: M is built and kept on the CSR's
    device, its ELL arrays equal the CPU port's (the columns exactly, the
    values within 1e-12 relative), and its application on a CUDA vector
    agrees within 1e-12."""
    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_matrix

    a = convection_diffusion_matrix(16, 0.4, 0.2, device="cpu").numpy()
    rows, cols = np.nonzero(a)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=a.shape[0]))])
    arrays = {"data": a[rows, cols], "indices": cols.astype(np.int32), "indptr": indptr}
    cpu = tt.spai_matrix(tt.sparse_from_numpy("csr", arrays, a.shape, device="cpu"))
    card = tt.spai_matrix(tt.sparse_from_numpy("csr", arrays, a.shape, device=cuda_device))
    assert card.data.device.type == "cuda"
    assert torch.equal(card.cols.cpu(), cpu.cols)
    assert rel_err(card.data.cpu(), cpu.data) < 1e-12
    v = seeded(74, (a.shape[0],))
    y = tsp.ell_spmv(card, to_torch(v, cuda_device))
    assert rel_err(y.cpu(), tsp.ell_spmv(cpu, to_torch(v))) < 1e-12


@pytest.mark.parametrize("cycle", ["poisson", "convdiff", "helmholtz"])
def test_mesh_cycle_runs_on_the_kernels(cuda_device, tmp_path, cycle):
    """The distributed cycles on a one-rank mesh of the card (an NCCL group
    made here): the sharded levels launch K1's halo form (one launch an
    exchange, counted where it launches), the replicated levels K2, and
    one application in float64 equals the mesh=None cycle on the card
    within 1e-13 relative; a
    Householder GMRES(10) solve with it converges on the halo operator."""
    import torch.distributed as dist

    from gmres_tpu_torch.parallel.halo import halo_exchange

    n = 256
    kh2 = 10 * tt.helmholtz_lambda_min(n)
    make = {
        "poisson": lambda **kw: tt.poisson_multigrid_preconditioner(n, **kw),
        "convdiff": lambda **kw: tt.convection_diffusion_multigrid_preconditioner(
            n, 0.4, 0.2, smoother="auto", **kw),
        "helmholtz": lambda **kw: tt.helmholtz_shifted_laplacian_preconditioner(n, kh2, **kw),
    }[cycle]
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        mesh = tt.solver_mesh(1)
        r = to_torch(seeded(75, (n, n)), cuda_device)
        plain = make()(r)
        dm = make(mesh=mesh, replicate_below=64)
        assert dm.replicate_from == 3  # levels 256, 128, 64 sharded
        before = (tst.stencil5_cuda.launches, tfu.chebk_cuda.launches)
        halo_exchange.exchanges = 0
        tst.stencil_5pt_pallas_halo.launches = 0
        z = dm(tt.shard_grid_vector(r, mesh))
        torch.cuda.synchronize()
        k1 = tst.stencil5_cuda.launches - before[0]
        k1_halo = tst.stencil_5pt_pallas_halo.launches
        assert halo_exchange.exchanges > 0 and k1_halo == halo_exchange.exchanges
        assert k1 >= k1_halo
        assert tfu.chebk_cuda.launches - before[1] > 0
        assert rel_err(z.full_tensor(), plain) <= 1e-13
        if cycle == "poisson":
            b_np = np_poisson(np.ones((n, n)))
            b = tt.shard_grid_vector(tt.as_tensor(b_np, cuda_device), mesh)
            res = tt.gmres(tt.halo_poisson_operator(mesh), b, restart=10, tol=1e-10, M=dm,
                           variant="householder", compute_v_err=False)
            xs = res.x.full_tensor().cpu().numpy()
            assert res.status == 0
            assert np.linalg.norm(b_np - np_poisson(xs)) / np.linalg.norm(b_np) < 1e-9
    finally:
        dist.destroy_process_group()


def test_plain_operator_on_a_cuda_dtensor(cuda_device, tmp_path):
    """poisson_operator(n) on a one-rank CUDA DTensor (an NCCL group made
    here) takes the DTensor route: one halo exchange and one launch of K1's
    halo form, equal to the plain tensor's K1 full-grid result; the split
    operator on a [Shard(1)] stack is one exchange and two halo-form
    launches. stencil5_cuda and chebk_cuda handed the DTensor raise
    TypeError before any launch (its data_ptr() is 0)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from gmres_tpu_torch.parallel.halo import halo_exchange

    n = 256
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        mesh = tt.solver_mesh(1)
        x = to_torch(seeded(76, (n, n)), cuda_device)
        cases = (
            (tt.poisson_operator(n), x, 0, 1),
            (tt.helmholtz_split_operator(n, 0.3, damping=0.2),
             to_torch(seeded(77, (2, n, n)), cuda_device), 1, 2),
        )
        for op, v, dim, launches in cases:
            halo_exchange.exchanges = 0
            tst.stencil_5pt_pallas_halo.launches = 0
            before = tst.stencil5_cuda.launches
            y = op(distribute_tensor(v, mesh, [Shard(dim)]))
            torch.cuda.synchronize()
            assert halo_exchange.exchanges == 1
            assert tst.stencil_5pt_pallas_halo.launches == launches
            assert tst.stencil5_cuda.launches == before + launches
            assert torch.equal(y.full_tensor(), op(v))
        xs = tt.shard_grid_vector(x, mesh)
        before = tst.stencil5_cuda.launches, tfu.chebk_cuda.launches
        with pytest.raises(TypeError, match="halo route"):
            tst.stencil5_cuda(xs)
        with pytest.raises(TypeError, match="8.6b"):
            tfu.chebk_cuda(xs, 1.0, [0.0, 1.0])
        assert (tst.stencil5_cuda.launches, tfu.chebk_cuda.launches) == before
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_on_a_rank_block_with_shifted_offsets(cuda_device, dtype):
    """K3 as the sharded route launches it for an interior rank (rank 1 of 4
    of the Poisson 256² DIA: its 16384 rows, x widened by h = 256 entries on
    either side, the offsets shifted by h; built here without a group):
    the whole matrix's K3 rows to the bit, and the plain rows version's."""
    n = 256
    a = tt.poisson_dia(n, dtype=dtype, device=cuda_device)
    x = to_torch(seeded(80, n * n), cuda_device).to(dtype)
    m, h = n * n // 4, n
    lo = m
    local = tsp.DIAMatrix(data=a.data[:, lo:lo + m].contiguous(),
                          offsets=tuple(o + h for o in a.offsets), shape=(m, m + 2 * h))
    xw = x[lo - h:lo + m + h].contiguous()
    before = tsp.dia_spmv_cuda.launches
    y = tsp.dia_spmv_pallas(local, xw)
    torch.cuda.synchronize()
    assert tsp.dia_spmv_cuda.launches == before + 1
    torch.testing.assert_close(y, tsp.dia_spmv_pallas(a, x)[lo:lo + m], rtol=0, atol=0)
    torch.testing.assert_close(y, tsp.dia_spmv(local, xw), rtol=0, atol=0)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-13)])
def test_k4_on_a_rank_block_rows(cuda_device, dtype, rtol):
    """K4 as the sharded route launches it for an interior rank (block rows
    4–7 of a 16 × 128² block-tridiagonal BSR, x the window of block columns
    3–8, the block columns shifted by 3): the whole matrix's K4 rows to the
    bit, and the einsum twin on the same block within rtol."""
    bs = 128
    a = _block_tridiagonal(cuda_device, dtype, 16, bs)
    x = to_torch(seeded(81, 16 * bs), cuda_device).to(dtype)
    local = tsp.BSRMatrix(data=a.data[4:8].contiguous(),
                          block_cols=(a.block_cols[4:8] - 3).contiguous(),
                          shape=(4 * bs, 6 * bs))
    xw = x[3 * bs:9 * bs].contiguous()
    before = tsp.bsr_spmv_cuda.launches
    y = tsp.bsr_spmv_pallas(local, xw)
    torch.cuda.synchronize()
    assert tsp.bsr_spmv_cuda.launches == before + 1
    torch.testing.assert_close(y, tsp.bsr_spmv_pallas(a, x)[4 * bs:8 * bs], rtol=0, atol=0)
    assert rel_err(y, tsp.bsr_spmv(local, xw)) < rtol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_k4_lanes_on_a_rank_block(cuda_device, dtype):
    """K3 and K4 on 4 lanes of an interior rank's rows, as the sparse
    operators' block form launches them (n_cols ≠ n_rows: x widened by the
    band, offsets or block columns shifted): one batched launch each, each
    lane the bits of its own single launch on the same rank block."""
    n, bs, lanes = 256, 128, 4
    a = tt.poisson_dia(n, dtype=dtype, device=cuda_device)
    m, h = n * n // 4, n
    local = tsp.DIAMatrix(data=a.data[:, m:2 * m].contiguous(),
                          offsets=tuple(o + h for o in a.offsets), shape=(m, m + 2 * h))
    b = _block_tridiagonal(cuda_device, dtype, 16, bs)
    local_b = tsp.BSRMatrix(data=b.data[4:8].contiguous(),
                            block_cols=(b.block_cols[4:8] - 3).contiguous(),
                            shape=(4 * bs, 6 * bs))
    for spmv, mat, wrapper in ((tsp.dia_spmv_pallas, local, tsp.dia_spmv_cuda),
                               (tsp.bsr_spmv_pallas, local_b, tsp.bsr_spmv_cuda)):
        xw = to_torch(seeded(82, (lanes, mat.shape[1])), cuda_device).to(dtype)
        before = wrapper.batched_launches
        y = spmv(mat, xw)
        torch.cuda.synchronize()
        assert wrapper.batched_launches == before + 1
        assert tuple(y.shape) == (lanes, mat.shape[0])
        for i in range(lanes):
            torch.testing.assert_close(y[i], spmv(mat, xw[i].contiguous()), rtol=0, atol=0)


def _one_rank_nccl(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    return tt.solver_mesh(1)


def _sparse_launches():
    return tsp.dia_spmv_cuda.launches, tsp.bsr_spmv_cuda.launches


def _spectral_sharded(name, dev, place):
    """One run of an 8.6b function at a small size on ``dev``, its b (probe,
    block, u0, x_like) passed through ``place``: (result, a value to
    compare)."""
    n = 64
    gen = torch.Generator(device="cpu").manual_seed(9)
    probe = torch.randn((n, n), generator=gen, dtype=torch.float64).to(dev)
    cd = tt.convection_diffusion_operator(n, 0.4, 0.2)
    poisson = tt.poisson_operator(n)
    if name == "lobpcg":
        x0 = torch.randn((3, n, n), generator=gen, dtype=torch.float64).to(dev)
        res = tt.lobpcg(poisson, place(x0, 1), tol=1e-9,
                        M=tt.poisson_multigrid_preconditioner(n))
        return res, res.eigenvalues
    if name == "arnoldi_eigs":
        res = tt.arnoldi_eigs(cd, place(probe), nev=4, steps=30, tol=1e-10)
        return res, res.eigenvalues
    if name == "arnoldi_eigs_real":
        res = tt.arnoldi_eigs_real(cd, place(probe), nev=4, steps=30, tol=1e-10)
        return res, res.eigenvalues
    if name == "subspace_eigs":
        res = tt.subspace_eigs(cd, place(torch.ones_like(probe)), nev=3, guard=5, iters=100)
        return res, res.eigenvalues
    if name == "expm_multiply":
        res = tt.expm_multiply(poisson, place(probe), 0.4, steps=30)
        return res, res.y
    if name == "exponential_evolve":
        res = tt.exponential_evolve(poisson, place(probe), dt=0.1, n_steps=3, steps=20)
        return res, res.u
    if name == "theta_evolve":
        res = tt.theta_evolve(poisson, place(probe), dt=0.5, n_steps=3, solver="cg", tol=1e-12,
                              M=tt.poisson_multigrid_preconditioner(n))
        return res, res.u
    res = tt.trace_funm(poisson, torch.log, place(probe), n_probes=4, steps=20)
    return res, res.value


SPECTRAL_86B = ["lobpcg", "arnoldi_eigs", "arnoldi_eigs_real", "subspace_eigs",
                "expm_multiply", "exponential_evolve", "theta_evolve", "trace_funm"]


def test_spectral_and_cycles_on_a_cuda_dtensor(cuda_device, tmp_path):
    """Each eigensolver, matrix function and time stepper on a one-rank CUDA
    DTensor (an NCCL group made here; LOBPCG's block [Shard(1)], the others
    [Shard(0)]) runs without handing a kernel wrapper a DTensor, launches
    K1, and equals its run on the plain CUDA tensor within 1e-10 relative
    (subspace iteration's sharded block is CholQR2's, the plain one LAPACK's
    QR: 1e-8); each mesh=None cycle on a CUDA DTensor is the distributed
    cycle (every 256² level sharded on one rank: K1's halo form, one launch
    an exchange), the plain cycle within 1e-13 relative."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from gmres_tpu_torch.parallel.halo import halo_exchange

    mesh = _one_rank_nccl(tmp_path)
    try:
        def place(t, dim=0):
            return distribute_tensor(t, mesh, [Shard(dim)])

        def full(v):
            return v.full_tensor() if hasattr(v, "full_tensor") else v

        for name in SPECTRAL_86B:
            _, plain = _spectral_sharded(name, cuda_device, lambda t, dim=0: t)
            before = _kernel_counts()
            halo_exchange.exchanges = 0
            tst.stencil_5pt_pallas_halo.launches = 0
            res, got = _spectral_sharded(name, cuda_device, place)
            torch.cuda.synchronize()
            assert _kernel_counts()["K1"] > before["K1"], name
            # The operator saw the rows sharded (not replicated by DTensor).
            assert halo_exchange.exchanges == tst.stencil_5pt_pallas_halo.launches > 0, name
            state = next((getattr(res, f) for f in ("x", "y", "u") if hasattr(res, f)), None)
            if state is not None:
                assert all(isinstance(p, Shard) for p in state.placements), name
            if name in ("lobpcg", "arnoldi_eigs", "arnoldi_eigs_real", "subspace_eigs"):
                got, plain = np.sort_complex(full(got).cpu().numpy()), \
                    np.sort_complex(plain.cpu().numpy())
            bound = 1e-8 if name == "subspace_eigs" else 1e-10
            assert rel_err(full(got), plain) < bound, name
        n = 256
        r = to_torch(seeded(82, (n, n)), cuda_device)
        for m in (tt.poisson_multigrid_preconditioner(n),
                  tt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2, smoother="auto"),
                  tt.helmholtz_shifted_laplacian_preconditioner(n, 0.5)):
            plain = m(r)
            halo_exchange.exchanges = 0
            tst.stencil_5pt_pallas_halo.launches = 0
            z = m(place(r))
            torch.cuda.synchronize()
            assert halo_exchange.exchanges == tst.stencil_5pt_pallas_halo.launches > 0
            assert rel_err(z.full_tensor(), plain) <= 1e-13
    finally:
        dist.destroy_process_group()


def test_sparse_formats_on_a_cuda_dtensor(cuda_device, tmp_path):
    """Every format on a one-rank CUDA DTensor x ([Shard(0)]): the plain CUDA
    product within 1e-12 relative (DIA and HYB to the bit), K3 launched on
    the DIA rows and K4 on the BSR block rows (the rank's plain tensors),
    one exchange for DIA, HYB and the BSR band and one all-gather for CSR,
    COO and ELL; CG on the sharded HYB takes the plain run's iterations."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from gmres_tpu_torch.parallel.halo import halo_exchange

    mesh = _one_rank_nccl(tmp_path)
    try:
        n = 64
        csr = tt.poisson_csr(n, device=cuda_device)
        mats = {"csr": csr, "coo": tt.coo_from_dense(tt.poisson_matrix(n, device="cpu").numpy(),
                                                     device=cuda_device),
                "ell": tt.csr_to_ell(csr), "dia": tt.poisson_dia(n, device=cuda_device),
                "hyb": tt.csr_to_hyb(csr),
                "bsr": _block_tridiagonal(cuda_device, torch.float64, 32, 128)}
        for name, a in mats.items():
            op = tt.sparse_operator(a)
            x = to_torch(seeded(83, a.shape[1]), cuda_device)
            plain = op(x)
            k = _sparse_launches()
            halo_exchange.exchanges = 0
            with CommDebugMode() as comm:
                y = op(distribute_tensor(x, mesh, [Shard(0)]))
            torch.cuda.synchronize()
            launched = tuple(b - a_ for a_, b in zip(k, _sparse_launches()))
            gathers = sum(v for op_, v in comm.get_comm_counts().items()
                          if "gather" in str(op_))
            band = name in ("dia", "hyb", "bsr")
            assert (halo_exchange.exchanges, gathers) == ((1, 0) if band else (0, 1)), name
            assert launched == {"dia": (1, 0), "hyb": (1, 0), "bsr": (0, 1)}.get(name, (0, 0))
            if name in ("dia", "hyb"):
                torch.testing.assert_close(y.full_tensor(), plain, rtol=0, atol=0)
            assert rel_err(y.full_tensor(), plain) < 1e-12, name
        op = tt.sparse_operator(mats["hyb"])
        b = op(torch.ones(n * n, dtype=torch.float64, device=cuda_device))
        plain = tt.cg(op, b, tol=1e-9)
        res = tt.cg(op, distribute_tensor(b, mesh, [Shard(0)]), tol=1e-9)
        assert (res.iterations, res.status) == (plain.iterations, plain.status)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The batched launches (a (lanes, rows, cols) block in one launch) and the
# vmap rules that reach them.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("shape,dtype", [((300, 300), torch.float32), ((300, 300), torch.float64),
                                         ((75, 301), torch.float32), ((1024, 1026), torch.float32),
                                         ((1024, 1024), torch.float64),
                                         ((2048, 2048), torch.float32)])
def test_batched_k1_equals_single_launches(cuda_device, shape, dtype, lanes):
    """K1 on a block: each lane bitwise one single launch, with one
    coefficient set and with a (lanes, 5) set, one a lane."""
    xb = to_torch(seeded(81, (lanes,) + shape), cuda_device).to(dtype)
    per_lane = to_torch(seeded(82, (lanes, 5)), cuda_device)
    before = tst.stencil5_cuda.batched_launches
    y = tst.stencil5_cuda(xb, None, None, COEFS)
    yp = tst.stencil5_cuda(xb, None, None, per_lane)
    torch.cuda.synchronize()
    assert tst.stencil5_cuda.batched_launches == before + 2
    for k in range(lanes):
        assert torch.equal(y[k], tst.stencil5_cuda(xb[k].contiguous(), None, None, COEFS))
        c = per_lane[k].tolist()
        assert torch.equal(yp[k], tst.stencil5_cuda(xb[k].contiguous(), None, None, c))
        assert torch.equal(yp[k], tst.stencil_5pt_general(xb[k], *c))


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("shape,dtype", [((300, 300), torch.float32), ((300, 300), torch.float64),
                                         ((2048, 2048), torch.float32)])
def test_batched_vcycle_forms_equal_single_launches(cuda_device, shape, dtype, lanes):
    rb = to_torch(seeded(83, (lanes,) + shape), cuda_device).to(dtype)
    eb = to_torch(seeded(84, (lanes,) + shape), cuda_device).to(dtype)
    ecb = to_torch(seeded(85, (lanes, shape[0] // 2, shape[1] // 2)), cuda_device).to(dtype)
    rc = tst.residual_restrict_cuda(rb, eb, COEFS)
    e2, r3 = tst.correct_residual_cuda(rb, eb, ecb, COEFS)
    torch.cuda.synchronize()
    for k in range(lanes):
        assert torch.equal(rc[k], tst.residual_restrict_cuda(rb[k], eb[k], COEFS))
        e1, r1 = tst.correct_residual_cuda(rb[k], eb[k], ecb[k], COEFS)
        assert torch.equal(e2[k], e1) and torch.equal(r3[k], r1)
        assert torch.equal(rc[k], tst.residual_restrict_plain(rb[k], eb[k], COEFS))


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("shape,order,path,dtype", [
    ((75, 75), 32, ("cluster", (16, 4)), torch.float32),
    ((16, 16), 32, ("cluster", (1, 0)), torch.float64),
    ((300, 300), 3, ("tiled", (8, 32)), torch.float32),
    ((2048, 2048), 3, ("tiled", (32, 128)), torch.float32),
    ((300, 300), 8, ("sweep", None), torch.float64),
])
def test_batched_k2_paths_equal_single_launches(cuda_device, shape, order, path, dtype, lanes):
    """K2 on a block on each path: each lane bitwise its single launch on
    the same path and the per-sweep path's, one launch for all lanes on a
    fused path."""
    rb = to_torch(seeded(86, (lanes,) + shape), cuda_device).to(dtype)
    theta, _, steps = tfu.chebyshev_k_scalars(0.5, 8.0, order)
    before = dict(tfu.chebk_cuda.launches_by_path)
    z = tfu.chebk_cuda(rb, theta, steps, COEFS, _path=path)
    torch.cuda.synchronize()
    n = order - 1 if path[0] == "sweep" else 1
    assert tfu.chebk_cuda.launches_by_path[path[0]] == before[path[0]] + n
    for k in range(lanes):
        assert torch.equal(z[k], tfu.chebk_cuda(rb[k], theta, steps, COEFS, _path=path))
        assert torch.equal(z[k], tfu.chebk_cuda(rb[k], theta, steps, COEFS,
                                                _path=("sweep", None)))


def test_row_apply_on_the_card_is_one_batched_launch(cuda_device):
    """The Poisson cycle and operator over a block through row_apply: no
    single-grid launch, one batched launch a kernel use, each row the bits
    of its own application."""
    n, s = 256, 4
    op, m = tt.poisson_operator(n), tt.poisson_multigrid_preconditioner(n)
    rows = to_torch(seeded(87, (s, n, n)), cuda_device)
    v = rows[0].contiguous()
    before = _kernel_counts()
    m(v)
    op(v)
    torch.cuda.synchronize()
    per_vector = {key: c - before[key] for key, c in _kernel_counts().items()}
    every, batched = _kernel_counts(), _batched_counts()
    calls = (tst.stencil_5pt_pallas.block_calls, tfu.poly_stencil_smoother_pallas.block_calls)
    zm = tt.ops.blas.row_apply(m, rows)
    za = tt.ops.blas.row_apply(op, rows)
    torch.cuda.synchronize()
    assert {key: c - batched[key] for key, c in _batched_counts().items()} == per_vector
    assert {key: c - every[key] for key, c in _kernel_counts().items()} == per_vector
    assert (tst.stencil_5pt_pallas.block_calls - calls[0],
            tfu.poly_stencil_smoother_pallas.block_calls - calls[1]) == (per_vector["K1"],
                                                                       per_vector["K2"])
    for k in range(s):
        assert torch.equal(zm[k], m(rows[k].contiguous()))
        assert torch.equal(za[k], op(rows[k].contiguous()))


@pytest.mark.parametrize("name", ["poisson", "convdiff"])
def test_autograd_through_row_apply_on_the_card(cuda_device, name):
    """torch.autograd through a block application of an operator on a CUDA
    block that requires grad: the forward and the transpose are one batched
    K1 launch each (Stencil5Grid on the block), and x's gradient is the
    loop's bitwise (one launch a row each way)."""
    n, s = 128, 3
    op = (tt.poisson_operator(n) if name == "poisson"
          else tt.convection_diffusion_operator(n, 0.4, 0.2))
    w = to_torch(seeded(91, (s, n, n)), cuda_device)
    grads, launched = [], []
    for apply in (tt.ops.blas.row_apply,
                  lambda fn, b: torch.stack([fn(b[i]) for i in range(b.shape[0])])):
        x = to_torch(seeded(92, (s, n, n)), cuda_device).requires_grad_()
        before = (tst.stencil5_cuda.launches, tst.stencil5_cuda.batched_launches,
                  tst.Stencil5Grid.rule_applications["transpose"])
        (g,) = torch.autograd.grad((apply(op, x) * w).sum(), x)
        torch.cuda.synchronize()
        launched.append((tst.stencil5_cuda.launches - before[0],
                         tst.stencil5_cuda.batched_launches - before[1],
                         tst.Stencil5Grid.rule_applications["transpose"] - before[2]))
        grads.append(g)
    assert launched == [(2, 2, 1), (2 * s, 0, s)]
    assert torch.equal(*grads)


def test_k3_k4_under_vmap_launch_once_per_lane(cuda_device):
    """K3 (DIA, and HYB's DIA part) and K4 under torch.func.vmap: their vmap
    rule gives the lanes one batched launch (one a 64-diagonal chunk for
    K3), each lane bitwise its own application. (The name is from when the
    rule launched once per lane.)"""
    n, s = 32, 3
    hyb = tt.csr_to_hyb(tt.poisson_csr(n, device=cuda_device))
    dia = tt.sparse_operator(tt.poisson_dia(n, device=cuda_device))
    dense = np.stack([np_poisson(e.reshape(n, n)).reshape(-1) for e in np.eye(n * n)], axis=1)
    bsr = tt.sparse_operator(tsp.bsr_from_dense(dense, 4, device=cuda_device))
    rows = to_torch(seeded(88, (s, n * n)), cuda_device)
    for op, counter in ((dia, tsp.dia_spmv_cuda), (tt.sparse_operator(hyb), tsp.dia_spmv_cuda),
                        (bsr, tsp.bsr_spmv_cuda)):
        before = (counter.launches, counter.batched_launches)
        out = tt.ops.blas.row_apply(op, rows)
        torch.cuda.synchronize()
        assert (counter.launches, counter.batched_launches) == (before[0] + 1, before[1] + 1)
        for k in range(s):
            assert torch.equal(out[k], op(rows[k]))


LANE_COUNTS = [1, 2, 4, 7, 8, 9, 16, 17]


@pytest.mark.parametrize("lanes", LANE_COUNTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_k3_equals_single_launches(cuda_device, dtype, lanes):
    """K3 on a (lanes, n) block, one launch a 64-diagonal chunk for all
    lanes (the Poisson DIA, and a 70-diagonal DIA that takes two chunks, the
    second accumulating), the lanes in chunks of up to 16 (9: one partial
    chunk; 17: a full one and a partial one): each lane bitwise its single
    launch and the plain version."""
    n = 300
    wide = np.zeros((n, n))
    for off in range(-35, 35):
        wide += np.diag(seeded(93 + off + 35, n - abs(off)), off)
    for a in (tt.poisson_dia(n, dtype=dtype, device=cuda_device),
              tsp.dia_from_dense(wide, device=cuda_device, dtype=dtype)):
        xb = to_torch(seeded(94, (lanes, a.shape[1])), cuda_device).to(dtype)
        before = (tsp.dia_spmv_cuda.launches, tsp.dia_spmv_cuda.batched_launches)
        y = tsp.dia_spmv_cuda(a, xb)
        torch.cuda.synchronize()
        chunks = -(-a.ndiags // tsp.DIA_MAX_DIAGS_PER_LAUNCH)
        batched = chunks if lanes > 1 else 0
        assert (tsp.dia_spmv_cuda.launches, tsp.dia_spmv_cuda.batched_launches) == (
            before[0] + chunks, before[1] + batched)
        assert y.shape == ((lanes, a.shape[0]) if lanes > 1 else (a.shape[0],))
        y = y.reshape(lanes, -1)
        for k in range(lanes):
            assert torch.equal(y[k], tsp.dia_spmv_cuda(a, xb[k]))
            assert torch.equal(y[k], tsp.dia_spmv(a, xb[k]))


@pytest.mark.parametrize("nbr,bs", [(16, 128), (7, 48), (33, 4), (5, 200), (6, 37)])
@pytest.mark.parametrize("lanes", LANE_COUNTS)
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-13)])
def test_batched_k4_equals_single_launches(cuda_device, dtype, rtol, lanes, nbr, bs):
    """K4 on a (lanes, n) block, one launch for all lanes, in chunks of up to
    8 in float32 and 4 in float64 (partial last chunks among them), at block
    sizes that fill the row tiles (128), leave the last tile partial (48,
    4), take two column steps, the second partial (200), and leave lanes of
    a warp without a column (37): each lane bitwise its single launch, and
    the einsum within rtol."""
    a = _block_tridiagonal(cuda_device, dtype, nbr, bs)
    xb = to_torch(seeded(95, (lanes, a.shape[1])), cuda_device).to(dtype)
    before = tsp.bsr_spmv_cuda.launches
    y = tsp.bsr_spmv_cuda(a, xb)
    torch.cuda.synchronize()
    assert tsp.bsr_spmv_cuda.launches == before + 1
    y = y.reshape(lanes, -1)
    for k in range(lanes):
        assert torch.equal(y[k], tsp.bsr_spmv_cuda(a, xb[k]))
        assert rel_err(y[k], tsp.bsr_spmv(a, xb[k])) < rtol


@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_k3_k4_launch_by_the_plan_and_refuse_another_grid(cuda_device, kernel):
    """The wrappers launch by spmv_lanes_plan: its grid, threads and shared
    bytes go to the C entry as they are, and a grid one CUDA block short of
    the kernel's work, or other threads, is refused
    (cudaErrorInvalidConfiguration) before any launch."""
    import ctypes

    from gmres_tpu_torch.ops import _cuda

    lanes, dtype = 9, torch.float32
    if kernel == "K3":
        a = tt.poisson_dia(40, dtype=dtype, device=cuda_device)
        plan = tsp.spmv_lanes_plan("K3", lanes, dtype, a.shape[0])
        fn = _cuda.entry("gt_dia_spmv", dtype)
        offs = (ctypes.c_int * len(a.offsets))(*a.offsets)
    else:
        a = _block_tridiagonal(cuda_device, dtype, 6, 48)
        plan = tsp.spmv_lanes_plan("K4", lanes, dtype, 6, 48)
        fn = _cuda.entry("gt_bsr_spmv", dtype)
    xb = to_torch(seeded(98, (lanes, a.shape[1])), cuda_device).to(dtype)
    y = torch.zeros((lanes, a.shape[0]), dtype=dtype, device=cuda_device)

    def call(grid, threads):
        if kernel == "K3":
            return fn(a.data.data_ptr(), xb.data_ptr(), y.data_ptr(), lanes, a.shape[0],
                      a.shape[1], offs, len(a.offsets), 0, plan.chunk, *grid, threads,
                      plan.shared_bytes, xb.device.index, _cuda.stream_of(xb))
        nbr, k, bs, _ = a.data.shape
        return fn(a.data.data_ptr(), a.block_cols.data_ptr(), xb.data_ptr(), y.data_ptr(),
                  lanes, nbr, a.shape[1] // bs, k, bs, plan.chunk, *grid, threads,
                  plan.shared_bytes, xb.device.index, _cuda.stream_of(xb))

    short = (plan.grid[0] - 1,) + tuple(plan.grid[1:])
    assert call(short, plan.threads) == 9   # cudaErrorInvalidConfiguration
    assert call(plan.grid, plan.threads // 2) == 9
    assert not torch.any(y)
    assert call(plan.grid, plan.threads) == 0
    torch.cuda.synchronize()
    spmv = tsp.dia_spmv_cuda if kernel == "K3" else tsp.bsr_spmv_cuda
    assert torch.equal(y, spmv(a, xb))


@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_batched_k3_k4_keep_a_poisoned_lane_to_itself(cuda_device, kernel):
    """A NaN and an Inf in one lane of a 9-lane float64 block (three chunks
    of K4, one of K3) reach no other lane's y: every other lane stays
    finite and bitwise its single launch; the poisoned lane is its single
    launch's, NaNs included."""
    if kernel == "K3":
        a = tt.poisson_dia(64, dtype=torch.float64, device=cuda_device)
        spmv = tsp.dia_spmv_cuda
    else:
        a = _block_tridiagonal(cuda_device, torch.float64, 8, 128)
        spmv = tsp.bsr_spmv_cuda
    xb = to_torch(seeded(96, (9, a.shape[1])), cuda_device)
    xb[3, 5] = float("nan")
    xb[3, 700] = float("inf")
    y = spmv(a, xb)
    torch.cuda.synchronize()
    for k in range(9):
        single = spmv(a, xb[k])
        if k == 3:
            assert not torch.isfinite(y[k]).all()
            torch.testing.assert_close(y[k], single, rtol=0, atol=0, equal_nan=True)
        else:
            assert torch.isfinite(y[k]).all()
            assert torch.equal(y[k], single)


def test_kernels_without_vmap_rules_refuse_vmap(cuda_device):
    """K5, K6, K7 and K1's halo form raise their named error under
    torch.func.vmap, before any launch."""
    rb = to_torch(seeded(89, (2, 64, 64)), cuda_device)
    calls = {
        "K5": lambda t: tfu.cheb2_cuda(t, None, None, 4.2, 0.2),
        "K6": lambda t: tst.stencil5_dd_cuda(t.float(), t.float()),
        "K7b": lambda t: tfu.axpy_dot_cuda(0.5, t, t, t)[0],
        "K1": lambda t: tst.stencil5_cuda(t, t[0], None),
    }
    for kernel, fn in calls.items():
        with pytest.raises(RuntimeError, match=f"kernel {kernel} .*torch.func transform"):
            torch.func.vmap(fn)(rb)


def test_batched_solves_on_the_card_equal_sequential(cuda_device):
    """batched_solve on the card: CG with the V-cycle, mixed Householder
    GMRES and BiCGSTAB over per-lane convection strengths (K1's per-lane
    coefficients); each lane bitwise its sequential solve on the card."""
    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_apply

    n = 64
    op, m = tt.poisson_operator(n), tt.poisson_multigrid_preconditioner(n)
    bs = to_torch(seeded(90, (3, n, n)), cuda_device)
    cases = [
        (tt.cg, dict(tol=1e-9, M=m)),
        (tt.gmres, dict(restart=10, tol=1e-10, M=m, inner_dtype=torch.float32,
                        certify="true", compute_v_err=False)),
    ]
    for solver, kw in cases:
        before = _batched_counts()
        res = tt.batched_solve(solver, op, bs, **kw)
        assert _batched_counts()["K2"] > before["K2"]
        for k in range(bs.shape[0]):
            single = solver(op, bs[k], **kw)
            assert int(res.iterations[k]) == single.iterations
            assert torch.equal(res.x[k], single.x)
    g = torch.tensor([0.0, 0.2, 0.4, 0.8], dtype=torch.float64, device=cuda_device)

    def cd(v, gx):
        return convection_diffusion_apply(v, gx, 0.5 * gx)

    ones = torch.ones((n, n), dtype=torch.float64, device=cuda_device)
    bcd = torch.stack([cd(ones, gx) for gx in g])
    before = tst.stencil5_cuda.batched_launches
    res = tt.batched_solve(tt.bicgstab, cd, bcd, lane_args=(g,), tol=1e-9)
    assert tst.stencil5_cuda.batched_launches > before
    for k in range(4):
        single = tt.bicgstab(lambda v: cd(v, g[k]), bcd[k], tol=1e-9)
        assert int(res.iterations[k]) == single.iterations
        assert torch.equal(res.x[k], single.x)


# ---------------------------------------------------------------------------
# K1's per-lane route with its rules, and nested (lanes, s) blocks: one
# launch for all lanes' grids.
# ---------------------------------------------------------------------------


def _lane_coefs(lanes, device, seed=93):
    c = seeded(seed, (lanes, 5)) * 0.3
    c[:, 0] += 4.0
    c[:, 1:] -= 1.0
    return to_torch(c, device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_per_lane_transpose_and_tangent_are_one_launch_each(cuda_device, dtype):
    """Stencil5Lanes on the card: the transpose one K1 launch on the
    cotangent block with each lane's mirrored coefficients, the tangent one
    launch; each lane bitwise its single transposed launch; the coefficient
    cotangent within rounding of the CPU rules'."""
    lanes, n = 8, 256
    c = _lane_coefs(lanes, cuda_device)
    x = to_torch(seeded(94, (lanes, n, n)), cuda_device).to(dtype).requires_grad_()
    ct = c.clone().requires_grad_()
    gy = to_torch(seeded(95, (lanes, n, n)), cuda_device).to(dtype)
    y = tst.Stencil5Lanes.apply(x, ct)
    before = (tst.stencil5_cuda.launches, tst.stencil5_cuda.batched_launches)
    gx, gc = torch.autograd.grad(y, (x, ct), gy)
    torch.cuda.synchronize()
    assert (tst.stencil5_cuda.launches - before[0],
            tst.stencil5_cuda.batched_launches - before[1]) == (1, 1)
    for k in range(lanes):
        single = tst.stencil5_cuda(gy[k].contiguous(), None, None,
                                   c[k, list(tst._MIRROR)].tolist())
        assert torch.equal(gx[k], single), k
    xc, cc = x.detach().cpu().requires_grad_(), c.cpu().requires_grad_()
    _, gc_cpu = torch.autograd.grad(tst.Stencil5Lanes.apply(xc, cc), (xc, cc), gy.cpu())
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    torch.testing.assert_close(gc.cpu(), gc_cpu, rtol=tol, atol=tol)
    tx = to_torch(seeded(96, (lanes, n, n)), cuda_device).to(dtype)
    before = tst.stencil5_cuda.launches
    _, t = torch.func.jvp(lambda v: tst.Stencil5Lanes.apply(v, c), (x.detach(),), (tx,))
    torch.cuda.synchronize()
    assert tst.stencil5_cuda.launches - before == 2
    assert torch.equal(t, tst.stencil5_cuda(tx, None, None, c))


def test_transposes_of_a_gamma_family_under_vjp_of_vmap(cuda_device):
    """A batched solve's transposes (requests.LaneTranspose): the pullback
    of the vmapped operator family, one K1 launch an application, each lane
    bitwise its sequential solve's derived transpose."""
    lanes, n = 4, 512
    gam = to_torch(np.array([0.1, 0.3, 0.5, 0.7]), cuda_device)
    like = to_torch(seeded(97, (lanes, n, n)), cuda_device)
    u = to_torch(seeded(98, (lanes, n, n)), cuda_device)

    def a(v, g):
        return tt.convection_diffusion_apply(v, g, 0.2)

    _, pullback = torch.func.vjp(lambda vb: torch.func.vmap(a)(vb, gam), like)
    before = (tst.stencil5_cuda.launches, tst.Stencil5Grid.rule_applications["transpose"])
    (got,) = pullback(u)
    torch.cuda.synchronize()
    assert (tst.stencil5_cuda.launches - before[0],
            tst.Stencil5Grid.rule_applications["transpose"] - before[1]) == (1, 1)
    for k in range(lanes):
        _, pb = torch.func.vjp(lambda v: a(v, gam[k]), like[k])
        assert torch.equal(got[k], pb(u[k])[0]), k


def test_nested_block_is_one_launch_a_kernel(cuda_device):
    """A (lanes, s) block through row_apply inside vmap: one K1 launch (per
    lane coefficients repeated down the rows) and one K1rr, K1cr and K2
    launch a V-cycle application, each row bitwise its own launch."""
    lanes, s, n = 3, 2, 256
    gam = to_torch(np.array([0.2, 0.4, 0.6]), cuda_device)
    x = to_torch(seeded(99, (lanes, s, n, n)), cuda_device)
    before = tst.stencil5_cuda.launches
    y = torch.func.vmap(lambda xl, g: tt.ops.blas.row_apply(
        lambda v: tt.convection_diffusion_apply(v, g, 0.2), xl))(x, gam)
    torch.cuda.synchronize()
    assert tst.stencil5_cuda.launches - before == 1
    for k in range(lanes):
        for j in range(s):
            assert torch.equal(y[k, j], tt.convection_diffusion_apply(
                x[k, j].contiguous(), float(gam[k]), 0.2))
    m = tt.poisson_multigrid_preconditioner(n)
    counters = (tst.residual_restrict_cuda, tst.correct_residual_cuda, tfu.chebk_cuda)
    m(x[0, 0])  # builds the cycle's plan
    torch.cuda.synchronize()
    single = [c.launches for c in counters]
    z0 = m(x[0, 0].contiguous())
    torch.cuda.synchronize()
    per_apply = [c.launches - b for c, b in zip(counters, single)]
    before = [c.launches for c in counters]
    z = torch.func.vmap(lambda xl: tt.ops.blas.row_apply(m, xl))(x)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == per_apply
    assert torch.equal(z[0, 0], z0)


def test_batched_qmr_lanes_on_the_card_are_their_sequential_solves(cuda_device):
    """batched_solve(qmr) over γ lanes on the card: each lane bitwise its
    sequential solve; an iteration's transposes of all lanes one K1 launch."""
    n = 32
    gam = to_torch(np.array([0.2, 0.4, 0.6]), cuda_device)

    def a(v, g):
        return tt.convection_diffusion_apply(v, g, 0.2)

    bs = torch.stack([a(torch.ones((n, n), dtype=torch.float64, device=cuda_device), g)
                      for g in gam])
    before = tst.Stencil5Grid.rule_applications["transpose"]
    res = tt.batched_solve(tt.qmr, a, bs, lane_args=(gam,), tol=1e-9, max_iterations=3000)
    torch.cuda.synchronize()
    transposes = tst.Stencil5Grid.rule_applications["transpose"] - before
    singles = [tt.qmr(lambda v, g=g: a(v, g), bs[k], tol=1e-9, max_iterations=3000)
               for k, g in enumerate(gam)]
    longest = max(s.iterations for s in singles)
    assert longest <= transposes < sum(s.iterations for s in singles)
    for k, single in enumerate(singles):
        assert int(res.iterations[k]) == single.iterations and single.converged
        assert torch.equal(res.x[k], single.x), k


def test_implicit_vmap_of_grad_on_the_card(cuda_device):
    """torch.func.vmap(torch.func.grad(loss)) through implicit_solve on the
    card (convdiff, GMRES): the lanes' solves batched, each lane's gradient
    within 1e-8 of its torch.func.grad."""
    n = 64
    b = torch.ones((n, n), dtype=torch.float64, device=cuda_device)

    def solver(op, rhs):
        return tt.gmres(op, rhs, restart=30, tol=1e-12, max_restarts=200,
                        compute_v_err=False)

    def loss(g):
        return torch.sum(tt.implicit_solve(
            lambda gm: (lambda v: tt.convection_diffusion_apply(v, gm, 0.1)), g, b,
            solver=solver) ** 2)

    gammas = to_torch(np.array([0.1, 0.3, 0.5]), cuda_device)
    before = dict(tt.implicit_solve.lane_paths)
    grads = torch.func.vmap(torch.func.grad(loss))(gammas)
    assert tt.implicit_solve.lane_paths["batched"] - before["batched"] == 2
    singles = torch.stack([torch.func.grad(loss)(g) for g in gammas])
    torch.testing.assert_close(grads, singles, rtol=1e-8, atol=0)
