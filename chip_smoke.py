#!/usr/bin/env python3
"""Smoke run of gmres_tpu_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py                      # the smoke run below
    python3 chip_smoke.py --k2-paths [OUT]     # K2's path table (JSONL to OUT)

Run from the root of a checkout on a machine with an H100 (the kernels are
built for sm_90a). It imports torch, numpy and gmres_tpu_torch only. The
``--k2-paths`` mode builds the kernels, then forces every path of kernel K2
that can take each multigrid shape (16² to 4096², orders 3, 8 and 32,
float32 and float64), holds each bitwise to the per-sweep path and times it
by CUDA-graph replay; ops/fused.py's chebk_plan is set from that table.
Phases of the smoke run:

1. Require CUDA (exit non-zero without it); print the card's name and
   power limit as nvidia-smi reports them.
2. Build the CUDA kernels from gmres_tpu_torch/csrc with nvcc (one nvcc per
   source, all started together); print the build time and ptxas's
   resource report.
3. Compare kernel K1 (5-point stencil) and kernel K2 (order-k polynomial
   smoother) with their plain PyTorch versions on the card, at the shapes
   the main path gives them; print the error against a tolerance stated
   per case, each kernel's and plain version's time (CUDA events, after a
   warm-up), the bound and, for K1, the time of F.conv2d with the cross
   kernel (the one PyTorch call that computes the same stencil). Each K2
   case also runs on K2's per-sweep path: the routed path (printed with its
   cluster or tile) must give the same bits and take no longer (3% for
   noise).
4. Solve the multigrid ``mg`` configuration (Householder GMRES, m=10,
   float32 Arnoldi cycles certified on the float64 true residual) at 300²
   and 2048²; check convergence with a float64 true residual computed
   independently in numpy, and that K1 and K2 were launched during the
   solves, K2 on its cluster path at both sizes (the coarse solves) and on
   its tiled path at 2048² (printed by path); profile one more solve of each
   (device time by kernel, and the device's busy share of the wall time).
5. Solve the reference configuration at 300² (float64, cbpr2, m=50).
6. At 64², check that the GPU solve and the port's CPU solve agree.
7. Compare kernel K3 (DIA SpMV) and kernel K4 (BSR SpMV) with their plain
   versions: K3 bitwise on the Poisson DIA and HYB matrices at 512², 1000²
   and 2048² and on a wide, ragged DIA; K4 on block-tridiagonal matrices of
   random 128² blocks (the spmv program's n = 2048, and 512 block rows) and
   on the 64² Poisson matrix in 64² blocks. Print times, bounds, Gnnz/s and
   the time of the PyTorch sparse CSR/BSR product on the same matrix.
8. The sparse solve of the ``cg`` program: cbpr2 CG on the HYB operator of
   the Poisson CSR matrix, float64, tol 1e-9 absolute, at 300² and 1000²
   (the median of 5 solves after a warm-up; one profiled 1000² solve), and
   the pipelined variant at 300²; each checked by an independent numpy
   residual and by K3's launch count.
9. GMRES (the reference configuration) on the 300² HYB operator, against
   phase 5's iteration count on the stencil; CG on the BSR form of the 64²
   Poisson matrix, which must launch K4.
10. At 64², check that the port's GPU and CPU CG on the HYB operator agree.
11. Compare kernel K5 (fused cbpr2 with halo rows) and kernel K7 (fused CG
    update, K7a; fused axpy-dot, K7b) with their plain versions: K5 bitwise
    at 304² float64 (the strong-scaling shard) with zero and with random
    halo rows and at 2048² float32; K7 on a 2048² float32 and a 304² float64
    block (elementwise outputs bitwise, the float32 sums to a stated
    tolerance). Print times, bounds, the time of F.conv2d with K5's
    function as a 3×3 cross kernel (cuDNN, TF32 off), and the time of the
    eager torch calls that K7 fuses (add, sub, dot; add, dot). Then call K7 through the
    public entry points as a per-shard caller would (no solver calls K7, as
    in gmres_tpu).
12. The strong-scaling configuration on the explicit-halo route with the
    fused halo cbpr2 (the program itself applies the reference cbpr2 over
    the GSPMD operator; the mathematics is the same): a one-rank NCCL
    process group, the port's mesh, the 304² right-hand side
    sharded over it, the halo operator (K1) and the fused halo cbpr2 (K5)
    under MGSR GMRES (cgs2,
    m=50, float64) at tol 1e-8 and 1e-15, the median wall of 3 solves, the
    counts against the JAX package's, the launches of K1 and K5 against the
    operator and preconditioner applications, a profiled solve; then the
    same solve on plain tensors (the DTensor layer's cost), one mgs2 solve
    and one CG solve on the same operators.
13. Compare kernel K6 (the float64-accurate stencil on (hi, lo) float32
    pairs) with its plain version, bitwise in both components and within
    1e-13 of the float64 oracle, at 2048² and 4096² (Poisson and general
    coefficients), timed by CUDA-graph replay beside its bound and the
    float64 F.conv2d (the nearest PyTorch call); then run the port's
    ``roofline`` program at its defaults (1024, 2048, 4096; reps 20;
    order 8), which prints every row, and check that K1, K2 and K6 were
    launched, that no row exceeds 1.05 of the HBM peak without a stated
    traffic model, and that K2's rows carry their fraction of the single
    pass (r read once, z written once).
14. On the same one-rank NCCL group: compare kernel K8 (the RDMA route's
    affine stencil, interior then edges) with its plain version, bitwise,
    at 304² and 2048² float32, with F.conv2d of the affine weights as the
    yardstick; then float32 MGSR GMRES at 304² with the RDMA operator and
    the RDMA cbpr2 (m=50, tol 1e-5) and CG on the RDMA operator (1e-4
    relative), 3 timed solves each, checked in numpy, with K8's launches
    against the operator and preconditioner applications and a profiled
    solve.

Phases 12–14 share one NCCL process group made by the script. Any failure
raises and exits non-zero. The line before the last is the
kernel report (JSON); the last line is the result (JSON).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
TOL = 1e-8
SOLVE_REPEATS = 11
CG_TOL = 1e-9  # the cg program's absolute tolerance
CG_REPEATS = 5
REF_EIG = (0.2, 8.2)  # cbpr2's interval, the reference's eigenvalue bounds
# Shapes of the sparse phases: the spmv program's default grid and the 2048²
# secondary; the ends of the cg program's grids (300:1000); the BSR cases
# (label, block rows, block size); the wide, ragged DIA of
# tests/test_sparse.py; the grid of the BSR solve and of the CPU check.
SPMV_GRIDS = (512, 2048)
CG_GRIDS = (300, 1000)
BSR_CASES = (("spmv program n=2048 bs=128", 16, 128),
             ("512 block rows bs=128", 512, 128))
WIDE_DIA = (700, (-301, -128, -17, 0, 17, 256, 301))
SMALL_GRID = 64
# The H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM bytes/s
# and non-tensor-core FLOP/s by dtype.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# Inner iterations of the reference configuration at 300² recorded by the
# JAX package (BENCH_r05.json, decomposition, CPU run).
JAX_REFERENCE_INNER = 1200
# The strong-scaling program's configuration (benchmarks/cli.py): 304²,
# m=50, MGSR with cgs2, cbpr2 on REF_EIG, float64, up to 1000 restarts.
STRONG_N = 304
STRONG_M = 50
# gmres_tpu's counts for it (restarts, inner iterations of the last cycle),
# from jax.jit(gmres(..., variant="mgsr")) of the JAX package on the CPU, the
# same on its explicit-halo route on 1 and 8 devices, except that at 1e-15
# the last cycle takes 20 iterations on 1 device and 21 on 8 (the order of
# rounding): the check allows 2 inner iterations.
JAX_STRONG_COUNTS = {1e-8: (24, 15), 1e-15: (56, 21)}
STRONG_REPEATS = 3
# The program certifies the preconditioned norm ‖M(b − A x)‖/‖b‖. Its
# independent numpy recomputation must meet tol, times this factor: at 1e-15
# the float64 rounding of b − A x over 304² points is a tenth of the target
# (the port's CPU solve: 9.943e-16 certified, 1.157e-15 recomputed in numpy).
STRONG_ROUNDING = {1e-8: 1.0, 1e-15: 2.0}
# The roofline program's default grids (benchmarks/cli.py), and the general
# coefficients of tests/test_dd_stencil.py for K6's second entry point.
ROOFLINE_GRIDS = (1024, 2048, 4096)
GENERAL_COEFS = (4.3, -1.2, -0.7, -1.9, -0.1)
# The RDMA route's solves (tests/test_rdma.py, dryrun_multichip): float32
# MGSR GMRES to 1e-5 with cbpr2 on REF_EIG, and CG on the operator to 1e-4.
# At 304² float32 CG's true residual floors near 5.7e-4 absolute (the port's
# CPU run), above an absolute 1e-4, and gmres_tpu's certification would then
# end the solve in BREAKDOWN; so CG is held to 1e-4 relative to ‖b‖ (rtol).
RDMA_GMRES_TOL = 1e-5
RDMA_CG_TOL = 1e-4


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def np_stencil(x):
    """Independent float64 5-point Laplacian in numpy (zero boundaries)."""
    import numpy as np

    y = 4.0 * x
    y[:, 1:] -= x[:, :-1]
    y[:, :-1] -= x[:, 1:]
    y[1:, :] -= x[:-1, :]
    y[:-1, :] -= x[1:, :]
    return y


def _events_ms(run, count: int) -> float:
    """Mean time of `count` units enqueued by run(), by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def call_ms(fn, reps: int) -> float:
    """Time of one eager call of fn, host launch overhead included: CUDA
    events around `reps` calls after a warm-up. For small kernels this is
    the host's launch rate, not the device's work."""
    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    return _events_ms(run, reps)


def device_ms(fn, reps: int, per_graph: int = 10) -> float:
    """Device time of one call of fn: `per_graph` calls captured in a CUDA
    graph, replayed `reps` times, so the host's launch overhead is out of
    the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            graph.replay()

    return _events_ms(run, reps * per_graph)


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """The least time (ms) the card could take for work that must move
    `nbytes` and do `flops` in `dtype`, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).replace("torch.", "")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_record(library, ref, reps: int) -> dict:
    """Time one PyTorch call that computes the kernel's function (eager
    calls between CUDA events: with enough work queued, the device time).
    A call that PyTorch refuses for this dtype or layout is reported."""
    import torch

    try:
        z = library()
        torch.cuda.synchronize()
    except RuntimeError as exc:
        msg = str(exc).splitlines()[0][:160]
        return {"library_ms": None, "library_note": f"refused: {msg}"}
    err = float((z.reshape(-1) - ref.reshape(-1)).abs().max())
    scale = float(ref.abs().max())
    return {"library_ms": call_ms(library, reps),
            "library_rel_err": err / scale if scale > 0 else err}


def compare(name, kernel, plain, rtol, reps, work=None, library=None):
    """Run kernel and plain version on the same inputs; return a record.
    `work` is (bytes, flops, dtype, nnz or None) for the bound and the rate;
    `library` a callable of one PyTorch call computing the same function."""
    import torch

    z_k = kernel()
    z_p = plain()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(z_k).all()), f"{name}: kernel output not finite")
    abs_err = float((z_k - z_p).abs().max())
    scale = float(z_p.abs().max())
    rel = abs_err / scale if scale > 0 else abs_err
    rec = {
        "case": name, "max_abs_err": abs_err, "max_rel_err": rel,
        "rtol": rtol, "ms": device_ms(kernel, reps),
        "plain_ms": device_ms(plain, reps),
        "call_ms": call_ms(kernel, reps), "plain_call_ms": call_ms(plain, reps),
        "bound_ms": None, "bound_by": None, "library_ms": None,
    }
    extra = ""
    if work is not None:
        nbytes, flops, dtype, nnz = work
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, dtype)
        extra += (f" bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
                  f"{100 * rec['bound_ms'] / rec['ms']:.0f}% of it)")
        if nnz:
            rec["gnnz_per_s"] = nnz / (rec["ms"] * 1e-3) / 1e9
            extra += f" {rec['gnnz_per_s']:.2f} Gnnz/s"
    if library is not None:
        rec.update(library_record(library, z_p, reps))
        if rec["library_ms"] is None:
            extra += f" library: {rec['library_note']}"
        else:
            extra += (f" library {rec['library_ms']:.4f} ms (eager, rel err "
                      f"{rec['library_rel_err']:.1e})")
    tol = "bitwise" if rtol == 0 else f"tol {rtol:.0e}"
    print(f"  {name:42s} rel_err {rel:.3e} ({tol})  device: kernel "
          f"{rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms  eager call: "
          f"kernel {rec['call_ms']:.4f} ms plain {rec['plain_call_ms']:.4f} ms"
          f"{extra}", flush=True)
    require(rel <= rtol, f"{name}: kernel disagrees with plain version "
            f"(rel err {rel:.3e} > {rtol:.0e})")
    return rec


def stencil_work(n, dt, sweeps=0, halo=False):
    """One read of the grid and one write of the result; 9 flops a point for
    the stencil, 14 a point for each smoother sweep after z₀ = r/θ."""
    import torch

    item = torch.empty((), dtype=dt).element_size()
    flops = n * n * (9 if sweeps == 0 else 1 + 14 * sweeps)
    return (2 * n * n + (2 * n if halo else 0)) * item, flops, dt, None


def k2_compare(name, r, theta, steps, coefs, rtol, reps, sweeps):
    """K2 on the path chebk_plan routes, against its plain version (compare),
    then against the per-sweep path in the same run: the same bits, and a
    time no worse than the per-sweep path's (3% for noise)."""
    import torch

    from gmres_tpu_torch.ops import fused

    path = fused.chebk_plan(*r.shape, len(steps) // 2, r.dtype)
    n = r.shape[0]
    rec = compare(name, lambda: fused.chebk_cuda(r, theta, steps, coefs),
                  lambda: fused.poly_stencil_smoother_plain(r, theta, steps, coefs),
                  rtol, reps, work=stencil_work(n, r.dtype, sweeps=sweeps))
    z_c = fused.chebk_cuda(r, theta, steps, coefs, _path=("sweep", None))
    z_k = fused.chebk_cuda(r, theta, steps, coefs)
    torch.cuda.synchronize()
    require(torch.equal(z_k, z_c), f"{name}: the {path[0]} path differs from the "
            "per-sweep path")
    rec["path"], rec["param"] = path
    rec["sweep_ms"] = device_ms(
        lambda: fused.chebk_cuda(r, theta, steps, coefs, _path=("sweep", None)), reps)
    print(f"  {name:42s} path {path[0]} {path[1]}: {rec['ms']:.4f} ms, per-sweep "
          f"path {rec['sweep_ms']:.4f} ms ({rec['sweep_ms'] / rec['ms']:.2f}x), bound "
          f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}); bitwise equal to the "
          "per-sweep path", flush=True)
    require(rec["ms"] <= 1.03 * rec["sweep_ms"],
            f"{name}: the {path[0]} path is slower than the per-sweep path")
    return rec


def phase_kernels(gt_torch, rng, dev):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from gmres_tpu_torch.ops import fused, stencil

    sizes = (300, 150, 128, 75, 1024, 2048)
    records = {"K1": [], "K2": []}
    print("phase 3: kernels against their plain versions", flush=True)
    coefs = (4.0, -1.0, -1.0, -1.0, -1.0)
    cross = [[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0], [0.0, -1.0, 0.0]]
    for n in sizes:
        reps = 200 if n <= 300 else 50
        for dt, rtol in ((torch.float32, 1e-6), (torch.float64, 1e-14)):
            tag = "f32" if dt == torch.float32 else "f64"
            x = torch.as_tensor(rng.standard_normal((n, n))).to(dev, dt)
            top = torch.as_tensor(rng.standard_normal(n)).to(dev, dt)
            bot = torch.as_tensor(rng.standard_normal(n)).to(dev, dt)
            w = torch.tensor(cross, dtype=dt, device=dev).reshape(1, 1, 3, 3)
            # K1's yardstick: the cross kernel as a convolution (cuDNN, TF32
            # off), at the largest grid.
            conv = ((lambda: F.conv2d(x[None, None], w, padding=1)[0, 0])
                    if n == sizes[-1] else None)
            records["K1"].append(compare(
                f"K1 {n}x{n} {tag}",
                lambda: stencil.stencil5_cuda(x, None, None, coefs),
                lambda: stencil.stencil_5pt_general(x, *coefs), rtol, reps,
                work=stencil_work(n, dt), library=conv))
            records["K1"].append(compare(
                f"K1 {n}x{n} {tag} halo rows",
                lambda: stencil.stencil5_cuda(x, top, bot, coefs),
                lambda: stencil.stencil_5pt_halo(x, top, bot, coefs),
                rtol, reps, work=stencil_work(n, dt, halo=True)))
            # Order-3 smoother on [2, 8]: the V-cycle's pre/post smoother.
            theta, _, steps = fused.chebyshev_k_scalars(2.0, 8.0, 3)
            records["K2"].append(k2_compare(
                f"K2 order 3 {n}x{n} {tag}", x, theta, steps, coefs,
                1e-5 if dt == torch.float32 else 1e-13, reps, 2))
    for n in (75, 16):
        lam_min = 8.0 * np.sin(np.pi / (2 * (n + 1))) ** 2
        theta, _, steps = fused.chebyshev_k_scalars(lam_min, 8.0, 32)
        for dt, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-11)):
            tag = "f32" if dt == torch.float32 else "f64"
            r = torch.as_tensor(rng.standard_normal((n, n))).to(dev, dt)
            records["K2"].append(k2_compare(
                f"K2 order 32 {n}x{n} {tag} (coarse solve)", r, theta, steps, coefs,
                rtol, 200, 31))
    # Damped Jacobi on a general (non-symmetric) stencil.
    gcoefs = (4.0, -1.2, -0.8, -1.1, -0.9)
    theta, steps = fused.jacobi_k_scalars(0.7, gcoefs[0], 8)
    r = torch.as_tensor(rng.standard_normal((300, 300))).to(dev, torch.float32)
    records["K2"].append(k2_compare(
        "K2 Jacobi order 8 300x300 f32 general coefs", r, theta, steps, gcoefs,
        1e-5, 200, 7))
    return records


# ---------------------------------------------------------------------------
# K2's path table (`python3 chip_smoke.py --k2-paths [out.jsonl]`): every
# path that can take each multigrid shape, forced, timed beside the per-sweep
# path and held bitwise to it. ops/fused.py's chebk_plan is set from it.
# ---------------------------------------------------------------------------

K2_PATH_SIZES = (16, 32, 64, 75, 128, 150, 256, 300, 512, 1024, 2048, 4096)
K2_TILES = ((8, 32), (16, 32), (16, 64), (32, 64), (16, 128), (32, 128), (64, 64),
            (16, 256), (32, 256), (64, 128), (8, 128), (8, 256))


def k2_candidates(r, nsteps):
    """Every cluster size (with each ghost depth) and tile (with each thread
    count) that can take r."""
    from gmres_tpu_torch.ops import fused

    rows, cols = r.shape
    item = r.element_size()
    out = [("sweep", None)]
    for c in fused.CLUSTER_SIZES:
        for g in ((0,) if c == 1 else (1, 2, 4, 8)):
            if (fused.cluster_fits(rows, cols, c, g, item)
                    and fused._cluster_schedulable(item == 8, rows, cols, c,
                                                   fused.cluster_threads(rows, cols, c, g),
                                                   g, r.device.index) > 0):
                out.append(("cluster", (c, g)))
    for t in K2_TILES:
        if t[0] > 2 * rows or t[1] > 2 * cols:
            continue
        if fused.tile_fits(t, nsteps, item):
            th = fused.tile_threads(t, nsteps, item)
            out.extend(("tiled", (*t, n)) for n in sorted({th, min(512, 2 * th)}))
    return out


def k2_paths(dev, out_path=None) -> None:
    import numpy as np
    import torch

    from gmres_tpu_torch.ops import fused

    rng = np.random.default_rng(SEED)
    rows_out = []
    print("K2 paths: device ms per call (CUDA-graph replay); every fused path "
          "bitwise equal to the per-sweep path", flush=True)
    for n in K2_PATH_SIZES:
        for order in ((3, 8, 32) if n <= 512 else (3, 8)):
            for dt in (torch.float32, torch.float64):
                tag = "f32" if dt == torch.float32 else "f64"
                lam_min = 8.0 * np.sin(np.pi / (2 * (n + 1))) ** 2
                theta, _, steps = fused.chebyshev_k_scalars(
                    lam_min if order > 3 else 2.0, 8.0, order)
                r = torch.as_tensor(rng.standard_normal((n, n))).to(dev, dt)
                ref = fused.chebk_cuda(r, theta, steps, _path=("sweep", None))
                reps = 20 if n <= 512 else 5
                times = {}
                for path in k2_candidates(r, order - 1):
                    z = fused.chebk_cuda(r, theta, steps, _path=path)
                    torch.cuda.synchronize()
                    require(torch.equal(z, ref), f"K2 {path} {n}x{n} order {order} "
                            f"{tag}: not bitwise equal to the per-sweep path")
                    t = device_ms(lambda p=path: fused.chebk_cuda(r, theta, steps, _path=p),
                                  reps)
                    times[path] = t
                    rows_out.append({"n": n, "order": order, "dtype": tag,
                                     "path": path[0], "param": path[1], "ms": t})
                t_c = times[("sweep", None)]
                best = {}
                for (p, param), t in times.items():
                    if p not in best or t < best[p][1]:
                        best[p] = (param, t)
                print(f"  {n:5d}² order {order:2d} {tag}: sweep {t_c:.4f}"
                      + "".join(f"  {p} {best[p][0]} {best[p][1]:.4f} "
                                f"({t_c / best[p][1]:.2f}x)"
                                for p in ("cluster", "tiled") if p in best), flush=True)
                del r, ref
    if out_path:
        with open(out_path, "w") as f:
            for row in rows_out:
                f.write(json.dumps(row) + "\n")


# ---------------------------------------------------------------------------
# Phase 7: K3 and K4.
# ---------------------------------------------------------------------------


def dia_work(a):
    """Bytes: the coefficient array, x and y once each; flops: a multiply
    and an add for each nonzero coefficient."""
    n_rows, n_cols = a.shape
    item = a.data.element_size()
    nnz = int((a.data != 0).sum())
    return (a.data.numel() + n_rows + n_cols) * item, 2 * nnz, a.data.dtype, nnz


def bsr_work(a):
    """Bytes: the blocks, the block columns, x and y once each; flops: a
    multiply and an add for each stored block entry."""
    item = a.data.element_size()
    nbr, k, bs, _ = a.data.shape
    nbytes = a.data.numel() * item + a.block_cols.numel() * 4 + 2 * nbr * bs * item
    nnz = int((a.data != 0).sum())
    return nbytes, 2 * a.data.numel(), a.data.dtype, nnz


def csr_library(csr, dt):
    """PyTorch's sparse CSR tensor of a port CSRMatrix (the yardstick)."""
    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta state"
        return torch.sparse_csr_tensor(csr.indptr, csr.indices,
                                       csr.data.to(dt), size=csr.shape,
                                       check_invariants=False)


def bsr_library(a):
    """PyTorch's sparse BSR tensor of a port BSRMatrix: its blocks without
    the all-zero padding blocks (a BSR row lists each block column once)."""
    import torch

    real = a.data.abs().amax(dim=(2, 3)) > 0
    counts = real.sum(dim=1)
    crow = torch.zeros(a.data.shape[0] + 1, dtype=torch.int32,
                       device=a.data.device)
    crow[1:] = torch.cumsum(counts, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta state"
        return torch.sparse_bsr_tensor(crow, a.block_cols[real], a.data[real],
                                       size=a.shape, check_invariants=False)


def block_tridiagonal(gt_torch, nbr, bs, dt, dev, gen):
    """Random (bs, bs) blocks on the block tridiagonal, made on the card; the
    first and last block rows end in an all-zero padding block with block
    column 0, the layout bsr_from_dense gives."""
    import torch

    data = torch.randn((nbr, 3, bs, bs), generator=gen, device=dev,
                       dtype=torch.float64).to(dt)
    i = torch.arange(nbr, device=dev)
    cols = torch.stack([i - 1, i, i + 1], dim=1)
    cols[0] = torch.tensor([0, 1, 0], device=dev)
    cols[-1] = torch.tensor([nbr - 2, nbr - 1, 0], device=dev)
    data[0, 2] = 0.0
    data[-1, 2] = 0.0
    return gt_torch.BSRMatrix(data=data, block_cols=cols.to(torch.int32),
                              shape=(nbr * bs, nbr * bs))


def cast_dia(gt_torch, a, dt):
    return gt_torch.DIAMatrix(data=a.data.to(dt), offsets=a.offsets,
                              shape=a.shape)


def phase_sparse_kernels(gt_torch, rng, a_small, dev):
    """K3 and K4 against their plain versions; returns the records, the HYB
    matrices built on the way (reused by the solves) and the BSR form of
    the dense Poisson matrix ``a_small``."""
    import numpy as np
    import torch

    from gmres_tpu_torch.ops import sparse

    records = {"K3": [], "K4": []}
    hyb = {}
    print("phase 7: sparse kernels against their plain versions", flush=True)
    for n in sorted(SPMV_GRIDS + CG_GRIDS[-1:]):
        t0 = time.perf_counter()
        csr = gt_torch.poisson_csr(n, device=dev)
        hyb[n] = gt_torch.csr_to_hyb(csr)
        print(f"  poisson_csr + csr_to_hyb {n}x{n} on the host: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        require(hyb[n].ell is None and hyb[n].dia.offsets == (-n, -1, 0, 1, n),
                f"csr_to_hyb {n}: the Poisson matrix is not pure DIA")
        reps = 200 if n <= 1000 else 50
        for dt in (torch.float32, torch.float64):
            if n not in SPMV_GRIDS and dt == torch.float32:
                continue  # the CG path's shape, which is float64
            tag = "f32" if dt == torch.float32 else "f64"
            x = torch.as_tensor(rng.standard_normal(n * n)).to(dev, dt)
            lib = csr_library(csr, dt)
            mats = [("HYB", cast_dia(gt_torch, hyb[n].dia, dt))]
            if n in SPMV_GRIDS:
                mats.insert(0, ("poisson_dia", gt_torch.poisson_dia(n, dtype=dt,
                                                                    device=dev)))
            for label, a in mats:
                records["K3"].append(compare(
                    f"K3 {label} {n}x{n} {tag}",
                    lambda: sparse.dia_spmv_cuda(a, x),
                    lambda: sparse.dia_spmv(a, x), 0.0, reps,
                    work=dia_work(a), library=lambda: lib @ x))
    # Wide and ragged offsets (the shape of tests/test_sparse.py's wide case).
    n, offsets = WIDE_DIA
    dense = np.zeros((n, n))
    for off in offsets:
        dense += np.diag(rng.standard_normal(n - abs(off)), k=off)
    for dt in (torch.float32, torch.float64):
        tag = "f32" if dt == torch.float32 else "f64"
        a = gt_torch.dia_from_dense(dense, device=dev, dtype=dt)
        lib = csr_library(gt_torch.csr_from_dense(dense, device=dev), dt)
        x = torch.as_tensor(rng.standard_normal(n)).to(dev, dt)
        records["K3"].append(compare(
            f"K3 wide offsets {n} {tag}", lambda: sparse.dia_spmv_cuda(a, x),
            lambda: sparse.dia_spmv(a, x), 0.0, 200, work=dia_work(a),
            library=lambda: lib @ x))

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    for label, nbr, bs in BSR_CASES:
        base = block_tridiagonal(gt_torch, nbr, bs, torch.float64, dev, gen)
        for dt, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
            tag = "f32" if dt == torch.float32 else "f64"
            a = gt_torch.BSRMatrix(data=base.data.to(dt),
                                   block_cols=base.block_cols, shape=base.shape)
            x = torch.as_tensor(rng.standard_normal(nbr * bs)).to(dev, dt)
            lib = bsr_library(a)
            records["K4"].append(compare(
                f"K4 {label} {tag}", lambda: sparse.bsr_spmv_cuda(a, x),
                lambda: sparse.bsr_spmv(a, x), rtol, 200 if nbr < 100 else 50,
                work=bsr_work(a), library=lambda: lib @ x))
    n = SMALL_GRID
    bsr_small = gt_torch.bsr_from_dense(a_small, n, device=dev)
    x = torch.as_tensor(rng.standard_normal(n * n)).to(dev, torch.float64)
    lib = bsr_library(bsr_small)
    records["K4"].append(compare(
        f"K4 Poisson {n}x{n} in {n}x{n} blocks f64 (the CG path)",
        lambda: sparse.bsr_spmv_cuda(bsr_small, x),
        lambda: sparse.bsr_spmv(bsr_small, x), 1e-13, 200,
        work=bsr_work(bsr_small), library=lambda: lib @ x))
    return records, hyb, bsr_small


def mg_solve(gt_torch, n, dev):
    import numpy as np
    import torch

    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np, dev)
    op = gt_torch.poisson_operator(n)
    m_inv = gt_torch.poisson_multigrid_preconditioner(n)

    def solve():
        return gt_torch.gmres(op, b, restart=10, tol=TOL, M=m_inv,
                              compute_v_err=False, inner_dtype=torch.float32,
                              certify="true")

    return b_np, m_inv, solve


def true_rel(b_np, x):
    import numpy as np

    x_np = x.detach().cpu().numpy().astype(np.float64)
    return float(np.linalg.norm(b_np - np_stencil(x_np)) / np.linalg.norm(b_np))


def timed(solve):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve()
    float(res.residual)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def profile_solve(solve, tag: str, wall_median: float) -> None:
    """Profile one solve: device time by kernel, and the device's busy share
    of the profiled wall time and of the unprofiled median."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = solve()
        float(res.residual)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # Kernel and copy events only (an operator's own entry repeats the time
    # of the kernels it launched).
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    print(f"profile {tag}: device busy {busy_ms:.3f} ms = "
          f"{100 * busy_ms / (wall * 1e3):.1f}% of the profiled wall "
          f"{wall * 1e3:.3f} ms, {100 * busy_ms / (wall_median * 1e3):.1f}% of "
          f"the unprofiled median {wall_median * 1e3:.3f} ms", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=12),
          flush=True)


def cg_solve(gt_torch, mat, n, dev, variant="classic"):
    """cbpr2 CG on a sparse operator, b = A·1 (flat), the cg program's
    tolerance; returns b as numpy and a closure that solves."""
    import numpy as np

    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np.reshape(-1), dev)
    op = gt_torch.sparse_operator(mat)
    m_inv = gt_torch.chebyshev_preconditioner(op, *REF_EIG)

    def solve():
        return gt_torch.cg(op, b, tol=CG_TOL, M=m_inv, variant=variant)

    return b_np, solve


def abs_residual(b_np, x, n):
    """Independent float64 ‖b − A x‖ in numpy, x read as an (n, n) grid."""
    import numpy as np

    x_np = x.detach().cpu().numpy().astype(np.float64).reshape(n, n)
    return float(np.linalg.norm(b_np - np_stencil(x_np)))


def quartiles(times) -> str:
    import numpy as np

    return (f"median {np.median(times):.4f} quartiles "
            f"{np.percentile(times, 25):.4f}-{np.percentile(times, 75):.4f} "
            f"min {min(times):.4f} max {max(times):.4f}")


def phase_cg(gt_torch, hyb, dev):
    """Phase 8; returns K3's launches over the timed solves."""
    import numpy as np

    from gmres_tpu_torch.ops import sparse

    k3_total = 0
    iterations = {}
    for n in CG_GRIDS:
        b_np, solve = cg_solve(gt_torch, hyb[n], n, dev)
        res, t_warm = timed(solve)  # warm-up
        sparse.dia_spmv_cuda.launches = 0
        times = []
        for _ in range(CG_REPEATS):
            res, t_solve = timed(solve)
            times.append(t_solve)
        k3 = sparse.dia_spmv_cuda.launches
        k3_total += k3
        iterations[n] = res.iterations
        err = abs_residual(b_np, res.x, n)
        print(f"phase 8: cbpr2 CG on HYB {n}x{n} f64: status {res.status}, "
              f"{res.iterations} iterations, {res.host_syncs} host syncs, "
              f"residual {float(res.residual):.3e}, numpy ‖b − A x‖ {err:.3e}; "
              f"wall s over {CG_REPEATS} solves: {quartiles(times)} (warm-up "
              f"{t_warm:.4f}); K3 launches {k3} = "
              f"{k3 / (CG_REPEATS * res.iterations):.3f} per iteration; "
              f"{1e3 * float(np.median(times)) / res.iterations:.4f} ms per "
              f"iteration", flush=True)
        if n == CG_GRIDS[-1]:
            profile_solve(solve, f"cg {n}x{n}", float(np.median(times)))
        require(res.status == 0, f"cg {n}: not converged (status {res.status})")
        require(err < CG_TOL, f"cg {n}: numpy residual {err:.3e} >= {CG_TOL}")
        require(k3 > 0, f"cg {n}: K3 not launched")
    # The pipelined recurrences drift from the true residual sooner than the
    # classic ones. At 300² and tol 1e-9, gmres_tpu's own pipelined solve
    # stops where classic CG stops, and its certification then finds
    # ‖b − A x‖ just above tol and downgrades it to BREAKDOWN
    # (tests/test_torch_cg.py::test_pipelined_certification_miss_matches_jax
    # pins the port to that). So the check here: the same iterations as
    # classic CG (±2), a true residual within 10% of tol, and CONVERGED or
    # that downgrade.
    n = CG_GRIDS[0]
    b_np, solve = cg_solve(gt_torch, hyb[n], n, dev, variant="pipelined")
    sparse.dia_spmv_cuda.launches = 0
    res, t_solve = timed(solve)
    k3 = sparse.dia_spmv_cuda.launches
    k3_total += k3
    err = abs_residual(b_np, res.x, n)
    print(f"phase 8: pipelined cbpr2 CG on HYB {n}x{n} f64: status {res.status}, "
          f"{res.iterations} iterations, {res.host_syncs} host syncs, numpy "
          f"‖b − A x‖ {err:.3e}, {t_solve:.4f} s, K3 launches {k3}", flush=True)
    require(res.status in (0, 2) and err < 1.1 * CG_TOL and k3 > 0
            and abs(res.iterations - iterations[n]) <= 2,
            f"pipelined cg {n}: failed")
    return k3_total


def phase_sparse_solvers(gt_torch, hyb, bsr_small, dev, ref_inner):
    """Phases 9 and 10; returns K4's launches in the BSR solve."""
    import numpy as np
    import torch

    from gmres_tpu_torch.ops import sparse

    # Phase 9: GMRES in the reference configuration on the HYB operator,
    # against the stencil's inner iterations (ref_inner); CG on BSR.
    n = CG_GRIDS[0]
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np.reshape(-1), dev)
    op = gt_torch.sparse_operator(hyb[n])
    m_ref = gt_torch.chebyshev_preconditioner(op, *REF_EIG)
    res, t_hyb = timed(lambda: gt_torch.gmres(op, b, restart=50, tol=TOL,
                                              M=m_ref, compute_v_err=False,
                                              certify="true"))
    rel = true_rel(b_np, res.x.reshape(n, n))
    hyb_inner = (res.restarts - 1) * 50 + res.iterations
    print(f"phase 9: reference GMRES on HYB {n}x{n}: status {res.status}, "
          f"{hyb_inner} inner iterations (stencil, phase 5: {ref_inner}), "
          f"true rel residual {rel:.3e}, {t_hyb:.4f} s", flush=True)
    require(res.status == 0 and rel <= TOL, "GMRES on HYB failed")
    require(abs(hyb_inner - ref_inner) <= 0.05 * ref_inner,
            "GMRES on HYB: inner iterations differ from the stencil's by > 5%")
    n = SMALL_GRID
    cg_small, k4_launches = {}, 0
    for label, mat in (("HYB", hyb[n]), ("BSR", bsr_small)):
        b_np, solve = cg_solve(gt_torch, mat, n, dev)
        sparse.dia_spmv_cuda.launches = sparse.bsr_spmv_cuda.launches = 0
        res, t_solve = timed(solve)
        k3, k4 = sparse.dia_spmv_cuda.launches, sparse.bsr_spmv_cuda.launches
        err = abs_residual(b_np, res.x, n)
        cg_small[label] = res
        print(f"phase 9: cbpr2 CG on {label} {n}x{n} f64: status {res.status}, "
              f"{res.iterations} iterations, numpy ‖b − A x‖ {err:.3e}, "
              f"{t_solve:.4f} s, launches K3 {k3} K4 {k4}", flush=True)
        require(res.status == 0 and err < CG_TOL, f"CG on {label} {n}: failed")
        if label == "BSR":
            k4_launches = k4
            require(k4 > 0 and k3 == 0, f"CG on BSR {n}: K4 not launched")
    require(abs(cg_small["BSR"].iterations - cg_small["HYB"].iterations) <= 2,
            f"CG on BSR and on HYB at {n}²: iterations differ by more than 2")

    # Phase 10: the port's GPU and CPU CG agree.
    b_np, solve = cg_solve(gt_torch, gt_torch.csr_to_hyb(
        gt_torch.poisson_csr(n, device="cpu")), n, torch.device("cpu"))
    res = solve()
    gpu = cg_small["HYB"]
    print(f"phase 10: {n}x{n} HYB CG, (iterations, status): GPU "
          f"({gpu.iterations}, {gpu.status}), CPU ({res.iterations}, "
          f"{res.status})", flush=True)
    require(res.status == gpu.status == 0, "phase 10: status")
    require(abs(res.iterations - gpu.iterations) <= 2,
            "phase 10: iteration counts differ by more than 2")
    return k4_launches


# ---------------------------------------------------------------------------
# Phase 11: K5 and K7.
# ---------------------------------------------------------------------------


def fused_work(numel, dt, vectors, flops_per_point):
    """Bytes: `vectors` passes over numel elements of dt (each input read once,
    each output written once); flops per point in dt."""
    import torch

    item = torch.empty((), dtype=dt).element_size()
    return vectors * numel * item, flops_per_point * numel, dt, None


def check_pair(name, outs_k, outs_p, rtols):
    """Per-output relative errors of a kernel returning several tensors."""
    errs = []
    for i, (a, b, rtol) in enumerate(zip(outs_k, outs_p, rtols)):
        abs_err = float((a.double() - b.double()).abs().max())
        scale = float(b.double().abs().max())
        rel = abs_err / scale if scale > 0 else abs_err
        require(rel <= rtol, f"{name}: output {i} disagrees with the plain "
                f"version (rel err {rel:.3e} > {rtol:.0e})")
        errs.append((abs_err, rel))
    return errs


def affine_conv(r, top, bot, coefs7):
    """The yardstick of K5 and K8, one F.conv2d: a·r + b·A(r) is a 5-point
    stencil with weights (a + b·c0) at the centre and b·c_k at the
    neighbours. With halo rows the block is extended by them and padded only
    at the sides; without (None), padded all round."""
    import torch
    import torch.nn.functional as F

    c0, cw, ce, cs, cn, a, b = coefs7
    w = torch.tensor([[0.0, b * cs, 0.0],
                      [b * cw, a + b * c0, b * ce],
                      [0.0, b * cn, 0.0]], dtype=r.dtype, device=r.device)
    w = w.reshape(1, 1, 3, 3)
    if top is None:
        return lambda: F.conv2d(r[None, None], w, padding=1)[0, 0]
    ext = torch.cat([top.reshape(1, -1), r, bot.reshape(1, -1)])
    return lambda: F.conv2d(ext[None, None], w, padding=(0, 1))[0, 0]


def cheb2_conv(r, top, bot, d, alpha, coefs):
    """K5's yardstick: by linearity z = r/d + α(r − A(r)/d) is the affine
    stencil (1/d + α)·r − (α/d)·A(r)."""
    return affine_conv(r, top, bot, (*coefs, 1.0 / d + alpha, -alpha / d))


def phase_fused_kernels(gt_torch, rng, dev):
    """K5 and K7 against their plain versions; returns the records and the
    K7 launches of the per-shard calls."""
    import torch

    from gmres_tpu_torch.ops import fused

    records = {"K5": [], "K7a": [], "K7b": []}
    print("phase 11: K5 and K7 against their plain versions", flush=True)
    d, alpha = fused.chebyshev_ref_scalars(*REF_EIG)
    coefs = (4.0, -1.0, -1.0, -1.0, -1.0)
    for n, dt, halos in ((STRONG_N, torch.float64, "zero"),
                         (STRONG_N, torch.float64, "random"),
                         (2048, torch.float32, "random")):
        tag = "f32" if dt == torch.float32 else "f64"
        r = torch.as_tensor(rng.standard_normal((n, n))).to(dev, dt)
        top = bot = None
        if halos == "random":
            top = torch.as_tensor(rng.standard_normal(n)).to(dev, dt)
            bot = torch.as_tensor(rng.standard_normal(n)).to(dev, dt)
        item = r.element_size()
        records["K5"].append(compare(
            f"K5 {n}x{n} {tag} {halos} halo rows",
            lambda: fused.cheb2_cuda(r, top, bot, d, alpha, coefs),
            lambda: fused.chebyshev_poisson_fused_plain(r, top, bot, d, alpha, coefs),
            0.0, 200 if n <= 304 else 50,
            work=((2 * n * n + (2 * n if top is not None else 0)) * item,
                  14 * n * n, dt, None),
            library=cheb2_conv(r, top, bot, d, alpha, coefs)))
    for n, dt in ((2048, torch.float32), (STRONG_N, torch.float64)):
        tag = "f32" if dt == torch.float32 else "f64"
        x, r, p, ap = (torch.as_tensor(rng.standard_normal((n, n))).to(dev, dt)
                       for _ in range(4))
        a = torch.tensor(0.37, dtype=dt, device=dev)
        reps = 200 if n <= 304 else 50
        for name, kernel, plain, work, calls, pair in (
            ("K7a", lambda: fused.cg_fused_update_cuda(x, r, p, ap, a),
             lambda: fused.cg_fused_update_plain(x, r, p, ap, a),
             fused_work(n * n, dt, 6, 6), "add, sub, dot",
             lambda: torch.dot(torch.sub(r, ap, alpha=0.37).view(-1),
                               torch.add(x, p, alpha=0.37).view(-1))),
            ("K7b", lambda: fused.axpy_dot_cuda(a, x, r, p),
             lambda: fused.axpy_dot_plain(a, x, r, p),
             fused_work(n * n, dt, 4, 4), "add, dot",
             lambda: torch.dot(torch.add(r, x, alpha=0.37).view(-1), p.view(-1))),
        ):
            case = f"{name} {n}x{n} {tag}"
            outs_k, outs_p = kernel(), plain()
            torch.cuda.synchronize()
            # Elementwise outputs bitwise (-fmad=false); the float32 sum in
            # another order than torch.sum's over n² terms: 1e-5 relative.
            errs = check_pair(case, outs_k, outs_p,
                              (0.0,) * (len(outs_k) - 1) + (1e-5,))
            again = kernel()[-1]
            torch.cuda.synchronize()
            require(float(again) == float(outs_k[-1]),
                    f"{case}: the sum changed between two calls")
            rec = {"case": case, "max_abs_err": max(e[0] for e in errs),
                   "max_rel_err": max(e[1] for e in errs),
                   "sum_rel_err": errs[-1][1],
                   "ms": device_ms(kernel, reps), "plain_ms": device_ms(plain, reps),
                   "library_ms": None, "torch_pair_ms": device_ms(pair, reps)}
            rec["bound_ms"], rec["bound_by"] = bound(*work[:3])
            records[name].append(rec)
            print(f"  {case:42s} elementwise bitwise, sum rel_err "
                  f"{errs[-1][1]:.3e} (tol 1e-05), deterministic  device: kernel "
                  f"{rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
                  f"{100 * rec['bound_ms'] / rec['ms']:.0f}% of it)", flush=True)
            print(f"  {case:42s} yardstick, not one call: the eager torch "
                  f"calls ({calls}) {rec['torch_pair_ms']:.4f} ms", flush=True)
    # The per-shard use of K7 (no solver calls it): a CG step's x/r update
    # and an axpy-dot on the strong-scaling shard, through the public names.
    x, r, p, ap = (torch.as_tensor(rng.standard_normal((STRONG_N, STRONG_N)))
                   .to(dev, torch.float64) for _ in range(4))
    fused.cg_fused_update_cuda.launches = fused.axpy_dot_cuda.launches = 0
    x, r, rsq = gt_torch.cg_fused_update(x, r, p, ap, 0.5)
    p, pz = gt_torch.axpy_dot(float(rsq), p, r, ap)
    torch.cuda.synchronize()
    k7 = (fused.cg_fused_update_cuda.launches, fused.axpy_dot_cuda.launches)
    require(k7 == (1, 1) and bool(torch.isfinite(pz)),
            f"phase 11: per-shard K7 calls launched {k7}")
    return records, k7


# ---------------------------------------------------------------------------
# Phase 12: the strong-scaling path on a one-rank mesh.
# ---------------------------------------------------------------------------


def cbpr2_scalars():
    """cbpr2's (d, α) on REF_EIG, the reference's closed form."""
    lo, hi = REF_EIG
    c, d = (hi - lo) / 2.0, (hi + lo) / 2.0
    return d, 1.0 / (d - (c / d / 2.0) ** 2)


def np_cbpr2(r):
    """Independent float64 cbpr2 (z = r/d; z += α(r − A z)) in numpy."""
    d, alpha = cbpr2_scalars()
    z = r / d
    return z + alpha * (r - np_stencil(z))


def cbpr2_min_eigenvalue(n):
    """The least eigenvalue of cbpr2's M = p(A) over A's spectrum: p is
    linear and decreasing, so it is p(λ_max). ‖b − A x‖ ≤ ‖M(b − A x)‖ / it."""
    import math

    d, alpha = cbpr2_scalars()
    lam_max = 8.0 * math.sin(n * math.pi / (2 * (n + 1))) ** 2
    return 1.0 / d + alpha * (1.0 - lam_max / d)


def counted(fn, calls, key):
    def wrapped(v):
        calls[key] += 1
        return fn(v)

    return wrapped


def phases_on_one_rank(gt_torch, rng, dev, workdir):
    """Phases 12–14 on a one-rank NCCL group made here (a file rendezvous in
    `workdir`); returns phase 12's launches of K1 and K5, and phase 13's and
    14's records and launches."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{workdir}/rendezvous",
                            rank=0, world_size=1)
    try:
        strong = strong_scaling_solves(gt_torch, dev)
        roofline = phase_roofline(gt_torch, rng, dev, workdir)
        rdma = phase_rdma(gt_torch, rng, dev)
        return strong, roofline, rdma
    finally:
        dist.destroy_process_group()


def strong_scaling_solves(gt_torch, dev):
    """The solves of phase 12 on a one-rank process group."""
    import numpy as np

    from gmres_tpu_torch.ops import fused, stencil

    n, m = STRONG_N, STRONG_M
    mesh = gt_torch.solver_mesh(1)
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.shard_grid_vector(gt_torch.as_tensor(b_np, dev), mesh)
    calls = {"A": 0, "M": 0}
    op = counted(gt_torch.halo_poisson_operator(mesh), calls, "A")
    m_inv = counted(gt_torch.halo_chebyshev_preconditioner(mesh, *REF_EIG),
                    calls, "M")
    p_min = cbpr2_min_eigenvalue(n)
    launches = {"K1": 0, "K5": 0}

    def check(res, tol, tag):
        require(gt_torch.ops.blas.is_dtensor(res.x), f"{tag}: x is not sharded")
        x = res.x.full_tensor().cpu().numpy()
        require(x.shape == (n, n) and bool(np.isfinite(x).all()),
                f"{tag}: x is not a finite {n}x{n} grid")
        r = b_np - np_stencil(x)
        prec = float(np.linalg.norm(np_cbpr2(r)) / np.linalg.norm(b_np))
        true = float(np.linalg.norm(r) / np.linalg.norm(b_np))
        factor = STRONG_ROUNDING[tol]
        require(res.status == 0, f"{tag}: status {res.status}")
        require(prec < factor * tol, f"{tag}: numpy ‖M(b − A x)‖/‖b‖ {prec:.3e} "
                f">= {factor} × tol")
        require(true <= factor * tol / p_min, f"{tag}: numpy ‖b − A x‖/‖b‖ "
                f"{true:.3e} > {factor} × tol / λ_min(M) = {factor * tol / p_min:.3e}")
        return prec, true

    for tol, (j_restarts, j_iters) in JAX_STRONG_COUNTS.items():
        def solve(tol=tol):
            return gt_torch.gmres(op, b, restart=m, tol=tol, M=m_inv,
                                  variant="mgsr", orthogonalization="cgs2",
                                  max_restarts=1000, compute_v_err=False)

        res, t_warm = timed(solve)  # warm-up
        stencil.stencil5_cuda.launches = fused.cheb2_cuda.launches = 0
        calls["A"] = calls["M"] = 0
        times = []
        for _ in range(STRONG_REPEATS):
            res, t_solve = timed(solve)
            times.append(t_solve)
        k1, k5 = stencil.stencil5_cuda.launches, fused.cheb2_cuda.launches
        launches["K1"] += k1
        launches["K5"] += k5
        total = (res.restarts - 1) * m + res.iterations
        j_total = (j_restarts - 1) * m + j_iters
        prec, true = check(res, tol, f"strong-scaling tol {tol:g}")
        print(f"phase 12: strong-scaling {n}x{n} halo, 1 rank, mgsr cgs2 m={m} "
              f"f64 tol {tol:g}: status {res.status}, {res.restarts} restarts, "
              f"{res.iterations} in the last cycle, {total} inner iterations "
              f"(gmres_tpu: {j_restarts}, {j_iters}, {j_total}), {res.host_syncs} "
              f"host syncs, residual {float(res.residual):.4e}, numpy "
              f"‖M(b − A x)‖/‖b‖ {prec:.4e}, ‖b − A x‖/‖b‖ {true:.4e}; wall s over "
              f"{STRONG_REPEATS} solves: {quartiles(times)} (warm-up {t_warm:.4f}); "
              f"{1e3 * float(np.median(times)) / total:.4f} ms per inner "
              f"iteration; launches over the {STRONG_REPEATS} solves: K1 {k1} "
              f"(operator applications {calls['A']}), K5 {k5} (preconditioner "
              f"applications {calls['M']})", flush=True)
        require(abs(total - j_total) <= 2,
                f"strong-scaling tol {tol:g}: {total} inner iterations, "
                f"gmres_tpu {j_total}")
        require(k1 == calls["A"] > 0 and k5 == calls["M"] > 0,
                f"strong-scaling tol {tol:g}: launches K1 {k1} K5 {k5} against "
                f"applications A {calls['A']} M {calls['M']}")
        if tol == TOL:
            profile_solve(solve, f"strong-scaling {n}x{n} tol {tol:g}",
                          float(np.median(times)))

    j_total = (JAX_STRONG_COUNTS[TOL][0] - 1) * m + JAX_STRONG_COUNTS[TOL][1]
    # The cost of the DTensor layer: the same solve (tol 1e-8) on plain
    # tensors, with the single-device operator and cbpr2 (K1 only).
    b_plain = gt_torch.as_tensor(b_np, dev)
    op_plain = gt_torch.poisson_operator(n)
    m_plain = gt_torch.chebyshev_preconditioner(op_plain, *REF_EIG)
    for _ in range(2):  # a warm-up, then the timed solve
        res, t_plain = timed(lambda: gt_torch.gmres(
            op_plain, b_plain, restart=m, tol=TOL, M=m_plain, variant="mgsr",
            max_restarts=1000, compute_v_err=False))
    total = (res.restarts - 1) * m + res.iterations
    print(f"phase 12: the same mgsr cgs2 solve at tol {TOL:g} on plain tensors "
          f"(poisson_operator, cbpr2 on it): status {res.status}, {total} inner "
          f"iterations, {t_plain:.4f} s = {1e3 * t_plain / total:.4f} ms per "
          f"inner iteration", flush=True)
    require(res.status == 0 and abs(total - j_total) <= 2,
            "strong-scaling on plain tensors failed")

    # The dryrun_multichip pair: MGSR with mgs2, and CG, on the same operators.
    stencil.stencil5_cuda.launches = fused.cheb2_cuda.launches = 0
    res, t_solve = timed(lambda: gt_torch.gmres(
        op, b, restart=m, tol=TOL, M=m_inv, variant="mgsr",
        orthogonalization="mgs2", max_restarts=1000, compute_v_err=False))
    total = (res.restarts - 1) * m + res.iterations
    prec, true = check(res, TOL, "strong-scaling mgs2")
    print(f"phase 12: mgsr mgs2 tol {TOL:g}: status {res.status}, {total} inner "
          f"iterations, numpy ‖M(b − A x)‖/‖b‖ {prec:.4e}, {t_solve:.4f} s, "
          f"launches K1 {stencil.stencil5_cuda.launches} K5 "
          f"{fused.cheb2_cuda.launches}", flush=True)
    require(abs(total - j_total) <= 2,
            f"strong-scaling mgs2: {total} inner iterations, cgs2's JAX count {j_total}")
    launches["K1"] += stencil.stencil5_cuda.launches
    launches["K5"] += fused.cheb2_cuda.launches
    stencil.stencil5_cuda.launches = fused.cheb2_cuda.launches = 0
    res, t_solve = timed(lambda: gt_torch.cg(op, b, tol=CG_TOL, M=m_inv))
    err = abs_residual(b_np, res.x.full_tensor(), n)
    print(f"phase 12: cbpr2 CG on the halo operator, tol {CG_TOL:g} absolute: "
          f"status {res.status}, {res.iterations} iterations, numpy ‖b − A x‖ "
          f"{err:.3e}, {t_solve:.4f} s, launches K1 {stencil.stencil5_cuda.launches} "
          f"K5 {fused.cheb2_cuda.launches}", flush=True)
    require(res.status == 0 and err < CG_TOL and fused.cheb2_cuda.launches > 0,
            "strong-scaling CG failed")
    launches["K1"] += stencil.stencil5_cuda.launches
    launches["K5"] += fused.cheb2_cuda.launches
    return launches


# ---------------------------------------------------------------------------
# Phase 13: K6 and the roofline program.
# ---------------------------------------------------------------------------


def phase_roofline(gt_torch, rng, dev, workdir):
    """K6 against its plain version, then the port's roofline program at its
    defaults; returns K6's records and the launches of K1, K2 and K6 during
    the program."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from gmres_tpu_torch.benchmarks import cli
    from gmres_tpu_torch.ops import dd, fused, stencil

    records = {"K6": []}
    print("phase 13: K6 against its plain version", flush=True)
    cross = torch.tensor([[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0], [0.0, -1.0, 0.0]],
                         dtype=torch.float64, device=dev).reshape(1, 1, 3, 3)
    for n in ROOFLINE_GRIDS[1:]:
        x = torch.as_tensor(rng.standard_normal((n, n))).to(dev)
        hi, lo = dd.dd_from_f64(x)
        for label, coefs in (("poisson", stencil.POISSON_COEFS), ("general", GENERAL_COEFS)):
            case = f"K6 {n}x{n} {label}"

            def kernel(coefs=coefs):
                return stencil.stencil5_dd_cuda(hi, lo, coefs)

            def plain(coefs=coefs):
                return stencil.stencil_5pt_dd_plain(hi, lo, coefs)

            outs_k, outs_p = kernel(), plain()
            torch.cuda.synchronize()
            # -fmad=false and the plain version's order: both components bitwise.
            errs = check_pair(case, outs_k, outs_p, (0.0, 0.0))
            oracle = stencil.stencil_5pt_general(x, *coefs)
            err64 = float((dd.dd_to_f64(outs_k) - oracle).abs().max() / oracle.abs().max())
            require(err64 < 1e-13, f"{case}: {err64:.3e} from the float64 oracle")
            rec = {"case": case, "max_abs_err": max(e[0] for e in errs),
                   "max_rel_err": max(e[1] for e in errs), "oracle_rel_err": err64,
                   "ms": device_ms(kernel, 50), "plain_ms": device_ms(plain, 50),
                   "library_ms": None}
            # Pairs in and out: 16 B a point; 9 float64 flops a point.
            rec["bound_ms"], rec["bound_by"] = bound(16 * n * n, 9 * n * n, torch.float64)
            if label == "poisson":
                # No PyTorch call computes the stencil on pairs; the nearest is
                # K1's yardstick, the float64 cross as one F.conv2d (cuDNN).
                rec["nearest_library_ms"] = call_ms(
                    lambda: F.conv2d(x[None, None], cross, padding=1)[0, 0], 50)
            records["K6"].append(rec)
            near = rec.get("nearest_library_ms")
            print(f"  {case:42s} bitwise (both components), {err64:.2e} from the "
                  f"float64 oracle  device: kernel {rec['ms']:.4f} ms plain "
                  f"{rec['plain_ms']:.4f} ms bound {rec['bound_ms']:.4f} ms "
                  f"({rec['bound_by']}, {100 * rec['bound_ms'] / rec['ms']:.0f}% of it)"
                  + ("" if near is None else
                     f"  nearest library call (float64 F.conv2d) {near:.4f} ms"),
                  flush=True)

    print(f"phase 13: python -m gmres_tpu_torch.benchmarks roofline (grids "
          f"{','.join(map(str, ROOFLINE_GRIDS))}, reps 20, order 8)", flush=True)
    jsonl = os.path.join(workdir, "roofline.jsonl")
    counters = (stencil.stencil5_cuda, fused.chebk_cuda, stencil.stencil5_dd_cuda)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    cli.main(["roofline", "--jsonl", jsonl])
    seconds = time.perf_counter() - t0
    k1, k2, k6 = (c.launches for c in counters)
    with open(jsonl) as f:
        rows = [json.loads(line) for line in f]
    print(f"phase 13: roofline program {seconds:.1f} s, {len(rows)} rows; launches "
          f"(captured in the chains' CUDA graphs, each replayed): K1 {k1}, K2 {k2}, "
          f"K6 {k6}", flush=True)
    names = {r["name"] for r in rows}
    for n in ROOFLINE_GRIDS:
        for row in (f"stencil-plain-f32-{n}", f"stencil-plain-f64-{n}",
                    f"stencil-pallas-blocked-f32-{n}", f"stencil-pallas-dd-f64-{n}",
                    f"chebk8-blocked-f32-{n}", f"mg-vcycle-f32-{n}"):
            require(row in names, f"roofline: row {row} missing")
    require(k1 > 0 and k2 > 0 and k6 > 0,
            f"roofline: K1 {k1}, K2 {k2}, K6 {k6} launches")
    kind = torch.cuda.get_device_name(0)
    for r in rows:
        require(r["device"] == kind and r["timing"].startswith("CUDA graph"),
                f"roofline {r['name']}: not timed on the card by CUDA graph")
        frac = r["fraction_of_peak"]
        require(frac is not None and np.isfinite(frac) and frac > 0,
                f"roofline {r['name']}: fraction of peak {frac}")
        require(frac <= 1.05 or "note" in r or r.get("l2_resident"),
                f"roofline {r['name']}: {frac:.3f} of peak without a traffic model")
        if r["name"].startswith("chebk"):
            single = r.get("fraction_of_single_pass")
            require(single is not None and np.isfinite(single) and 0 < single,
                    f"roofline {r['name']}: fraction_of_single_pass {single}")
    return records, {"K1": k1, "K2": k2, "K6": k6}


# ---------------------------------------------------------------------------
# Phase 14: K8 and the RDMA route on a one-rank mesh.
# ---------------------------------------------------------------------------


def phase_rdma(gt_torch, rng, dev):
    """K8 against its plain version, then f32 MGSR GMRES with A and M on the
    RDMA route and CG on the RDMA operator at the strong-scaling grid;
    returns K8's records and launches."""
    import numpy as np
    import torch

    from gmres_tpu_torch.ops import fused, stencil_rdma as rd
    from gmres_tpu_torch.parallel.halo import (
        rdma_chebyshev_preconditioner,
        rdma_stencil_operator,
    )

    records = {"K8": []}
    print("phase 14: K8 against its plain version", flush=True)
    d, alpha = fused.chebyshev_ref_scalars(*REF_EIG)
    coefs = (4.0, -1.0, -1.0, -1.0, -1.0)
    forms = {"operator": (0.0, 1.0), "cbpr2": (1.0 / d + alpha, -alpha / d)}
    for n, form, halos in ((STRONG_N, "operator", "zero"), (STRONG_N, "cbpr2", "zero"),
                           (STRONG_N, "cbpr2", "random"), (2048, "operator", "zero"),
                           (2048, "cbpr2", "random")):
        dt = torch.float32
        x = torch.as_tensor(rng.standard_normal((n, n))).to(dev, dt)
        top = torch.zeros((1, n), dtype=dt, device=dev)
        bot = torch.zeros_like(top)
        if halos == "random":
            top = torch.as_tensor(rng.standard_normal((1, n))).to(dev, dt)
            bot = torch.as_tensor(rng.standard_normal((1, n))).to(dev, dt)
        c7 = (*coefs, *forms[form])
        c = rd._coefs7(c7, dt)
        records["K8"].append(compare(
            f"K8 {n}x{n} f32 {form} {halos} halo rows",
            lambda: rd.rdma_edges_cuda(rd.rdma_interior_cuda(x, c), top, bot, c),
            lambda: rd.rdma_edges_plain(rd.rdma_interior_plain(x, c), top, bot, c),
            0.0, 200 if n <= STRONG_N else 50,
            # x and the two halo rows read, y written; 12 flops a point, and
            # 3 more at each point of the two boundary rows.
            work=((2 * n * n + 2 * n) * 4, 12 * n * n + 6 * n, dt, None),
            library=affine_conv(x, top if halos == "random" else None, bot, c7)))

    n = STRONG_N
    mesh = gt_torch.solver_mesh(1)
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.shard_grid_vector(gt_torch.as_tensor(b_np, dev, torch.float32), mesh)
    calls = {"A": 0, "M": 0}
    op = counted(rdma_stencil_operator(mesh), calls, "A")
    m_inv = counted(rdma_chebyshev_preconditioner(mesh, *REF_EIG), calls, "M")
    p_min = cbpr2_min_eigenvalue(n)
    nb = float(np.linalg.norm(b_np))
    launches = {"interior": 0, "edges": 0}

    solves = (
        ("gmres", lambda: gt_torch.gmres(op, b, restart=STRONG_M, tol=RDMA_GMRES_TOL,
                                         M=m_inv, variant="mgsr", max_restarts=1000,
                                         compute_v_err=False)),
        ("cg", lambda: gt_torch.cg(op, b, tol=RDMA_CG_TOL, rtol=RDMA_CG_TOL)),
    )
    for name, solve in solves:
        res, t_warm = timed(solve)  # warm-up
        rd.rdma_interior_cuda.launches = rd.rdma_edges_cuda.launches = 0
        calls["A"] = calls["M"] = 0
        times = []
        for _ in range(STRONG_REPEATS):
            res, t_solve = timed(solve)
            times.append(t_solve)
        interior, edges = rd.rdma_interior_cuda.launches, rd.rdma_edges_cuda.launches
        launches["interior"] += interior
        launches["edges"] += edges
        require(gt_torch.ops.blas.is_dtensor(res.x), f"rdma {name}: x is not sharded")
        x = res.x.full_tensor().cpu().numpy()
        require(x.dtype == np.float32 and x.shape == (n, n) and bool(np.isfinite(x).all()),
                f"rdma {name}: x is not a finite float32 {n}x{n} grid")
        r = b_np - np_stencil(x.astype(np.float64))
        true = float(np.linalg.norm(r))
        if name == "gmres":
            total = (res.restarts - 1) * STRONG_M + res.iterations
            prec = float(np.linalg.norm(np_cbpr2(r)) / nb)
            counts = (f"{res.restarts} restarts, {res.iterations} in the last cycle, "
                      f"{total} inner iterations")
            check = (f"numpy ‖M(b − A x)‖/‖b‖ {prec:.4e}, ‖b − A x‖/‖b‖ "
                     f"{true / nb:.4e}")
            # The certified norm is float32 arithmetic; numpy recomputes it in
            # float64 from the float32 x (CPU rehearsal: 9.9315e-6 against a
            # certified 9.9279e-6), hence the 10%.
            ok = (prec < 1.1 * RDMA_GMRES_TOL
                  and true / nb <= 1.1 * RDMA_GMRES_TOL / p_min)
            applied = calls["A"] + calls["M"]
        else:
            counts = f"{res.iterations} iterations"
            check = f"numpy ‖b − A x‖ {true:.4e} (target {RDMA_CG_TOL * nb:.4e})"
            ok = true < 1.1 * RDMA_CG_TOL * nb
            applied = calls["A"]
            require(calls["M"] == 0, "rdma cg: a preconditioner was applied")
        print(f"phase 14: {name} {n}x{n} on the RDMA route, 1 rank, f32: status "
              f"{res.status}, {counts}, {res.host_syncs} host syncs, residual "
              f"{float(res.residual):.4e}, {check}; wall s over {STRONG_REPEATS} solves: "
              f"{quartiles(times)} (warm-up {t_warm:.4f}); K8 launches over the "
              f"{STRONG_REPEATS} solves: interior {interior}, edges {edges} "
              f"(applications: A {calls['A']}, M {calls['M']})", flush=True)
        require(res.status == 0, f"rdma {name}: status {res.status}")
        require(ok, f"rdma {name}: the numpy residual misses the tolerance ({check})")
        require(interior == edges == applied > 0,
                f"rdma {name}: K8 launches {interior}/{edges} against {applied} "
                f"applications")
        profile_solve(solve, f"rdma {name} {n}x{n}", float(np.median(times)))
    return records, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np

    import gmres_tpu_torch as gt_torch
    from gmres_tpu_torch.ops import _cuda, fused, stencil

    pkg_dir = os.path.dirname(os.path.abspath(gt_torch.__file__))
    require(pkg_dir == os.path.join(HERE, "gmres_tpu_torch"),
            f"gmres_tpu_torch imported from {pkg_dir}, not from this checkout")

    # Phase 1: the card.
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {kind} (capability {torch.cuda.get_device_capability(0)})",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "float32 matmuls must not use TF32")
    dev = torch.device("cuda", 0)

    # Phase 2: build.
    t0 = time.perf_counter()
    _cuda.load()
    print(f"phase 2: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {_cuda.build_seconds:.1f} s)",
          flush=True)
    for line in _cuda.build_log.splitlines():
        if "Used" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    if sys.argv[1:2] == ["--k2-paths"]:
        section = _cuda.build_log.split("== chebk.cu")[-1].split("\n== ")[0]
        print(f"  ptxas, chebk.cu:{section}", flush=True)
        k2_paths(dev, sys.argv[2] if len(sys.argv) > 2 else None)
        return 0

    # Phase 3: kernels against their plain versions.
    rng = np.random.default_rng(SEED)
    records = phase_kernels(gt_torch, rng, dev)

    # Phase 4: the mg configuration on the main path.
    launches = {}
    for n in (300, 2048):
        b_np, m_inv, solve = mg_solve(gt_torch, n, dev)
        res, t_warm = timed(solve)  # warm-up
        stencil.stencil5_cuda.launches = 0
        fused.chebk_cuda.launches = 0
        fused.chebk_cuda.launches_by_path = dict.fromkeys(fused.chebk_cuda.launches_by_path, 0)
        times = []
        for _ in range(SOLVE_REPEATS):
            res, t_solve = timed(solve)
            times.append(t_solve)
        k1, k2 = stencil.stencil5_cuda.launches, fused.chebk_cuda.launches
        k2_paths_mg = dict(fused.chebk_cuda.launches_by_path)
        launches[n] = (k1, k2, k2_paths_mg)
        rel = true_rel(b_np, res.x)
        total_inner = (res.restarts - 1) * 10 + res.iterations
        print(f"phase 4: mg {n}x{n} ({m_inv.levels} levels): status "
              f"{res.status}, {total_inner} inner iterations, {res.restarts} "
              f"restarts, {res.host_syncs} host syncs, true rel residual "
              f"{rel:.3e}; wall s over {SOLVE_REPEATS} solves: median "
              f"{np.median(times):.4f} quartiles "
              f"{np.percentile(times, 25):.4f}-{np.percentile(times, 75):.4f} "
              f"min {min(times):.4f} max {max(times):.4f} (warm-up "
              f"{t_warm:.4f}); "
              f"launches over the {SOLVE_REPEATS} solves: K1 {k1}, K2 {k2} (by path: "
              f"{k2_paths_mg}; levels {m_inv.plan.sizes}, K2 plans: "
              f"{[fused.chebk_plan(m, m, 2, torch.float32) for m in m_inv.plan.sizes[:-1]]} "
              f"and coarse {fused.chebk_plan(*(m_inv.plan.sizes[-1],) * 2, 31, torch.float32)})",
              flush=True)
        profile_solve(solve, f"mg {n}x{n}", float(np.median(times)))
        require(res.status == 0, f"mg {n}: not converged (status {res.status})")
        require(rel <= TOL, f"mg {n}: true relative residual {rel:.3e} > {TOL}")
        require(k1 > 0 and k2 > 0, f"mg {n}: K1/K2 not launched ({k1}, {k2})")
        require(k2_paths_mg["cluster"] > 0 and (n < 2048 or k2_paths_mg["tiled"] > 0),
                f"mg {n}: K2 launches by path {k2_paths_mg}")
        require(sum(k2_paths_mg.values()) == k2, f"mg {n}: K2 launches by path do not add up")
        require(tuple(res.x.shape) == (n, n), f"mg {n}: wrong x shape")

    # Phase 5: the reference configuration (float64 cbpr2, m=50) at 300².
    n = 300
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np, dev)
    op = gt_torch.poisson_operator(n)
    m_ref = gt_torch.chebyshev_preconditioner(op, 0.2, 8.2)

    def solve_ref():
        return gt_torch.gmres(op, b, restart=50, tol=TOL, M=m_ref,
                              compute_v_err=False, certify="true")

    res, t_warm = timed(solve_ref)
    stencil.stencil5_cuda.launches = 0
    res, t_ref = timed(solve_ref)
    rel = true_rel(b_np, res.x)
    total_inner = (res.restarts - 1) * 50 + res.iterations
    print(f"phase 5: reference 300x300 f64 cbpr2 m=50: status {res.status}, "
          f"{total_inner} inner iterations (JAX package recorded "
          f"{JAX_REFERENCE_INNER}), {res.restarts} restarts, {res.host_syncs} "
          f"host syncs, true rel residual {rel:.3e}, {t_ref:.4f} s (warm-up "
          f"{t_warm:.4f} s), K1 launches {stencil.stencil5_cuda.launches}",
          flush=True)
    require(res.status == 0 and rel <= TOL, "reference configuration failed")
    ref_inner = total_inner

    # Phase 6: GPU and CPU solves of the port agree at 64².
    n = 64
    counts = {}
    for where in (dev, torch.device("cpu")):
        b_np, _, solve = mg_solve(gt_torch, n, where)
        res = solve()
        rel = true_rel(b_np, res.x)
        counts[where.type] = ((res.restarts - 1) * 10 + res.iterations,
                              res.status, rel)
    print(f"phase 6: 64x64 mg, (inner iterations, status, true rel residual): "
          f"GPU {counts['cuda']}, CPU {counts['cpu']}", flush=True)
    require(counts["cuda"][1] == counts["cpu"][1] == 0, "phase 6: status")
    require(counts["cuda"][2] <= TOL and counts["cpu"][2] <= TOL,
            "phase 6: not converged")
    require(abs(counts["cuda"][0] - counts["cpu"][0]) <= 2,
            "phase 6: inner iteration counts differ by more than 2")

    # Phase 7: K3 and K4 against their plain versions.
    a_small = gt_torch.poisson_matrix(SMALL_GRID, device="cpu").numpy()
    sp_records, hyb, bsr_small = phase_sparse_kernels(gt_torch, rng, a_small,
                                                      dev)
    records.update(sp_records)

    # Phase 8: the cg program's sparse solve.
    for n in (CG_GRIDS[0], SMALL_GRID):
        hyb[n] = gt_torch.csr_to_hyb(gt_torch.poisson_csr(n, device=dev))
    launches["K3"] = phase_cg(gt_torch, hyb, dev)

    # Phases 9 and 10: the other operators on a solver path; CPU and GPU.
    launches["K4"] = phase_sparse_solvers(gt_torch, hyb, bsr_small, dev,
                                          ref_inner)

    # Phase 11: K5 and K7 against their plain versions; K7's per-shard calls.
    fused_records, k7_launches = phase_fused_kernels(gt_torch, rng, dev)
    records.update(fused_records)

    # Phase 12: the strong-scaling path (halo operator, K1 and K5, MGSR);
    # phase 13: K6 and the roofline program; phase 14: K8 and the RDMA route.
    with tempfile.TemporaryDirectory() as workdir:
        strong, (dd_records, roof), (rdma_records, k8) = phases_on_one_rank(
            gt_torch, rng, dev, workdir)
    records.update(dd_records)
    records.update(rdma_records)

    def report(name, src, replaces, also, n_launches, timed_at, **extra):
        recs = records[name]
        rec = [r for r in recs if r["case"] == timed_at][0]
        return {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "also_replaces": also,
            "launches": n_launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "timed_at": timed_at, **extra,
        }

    mg_k1, mg_k2 = launches[2048][0] + launches[300][0], launches[2048][1] + launches[300][1]
    mg_k2_paths = {p: launches[2048][2][p] + launches[300][2][p] for p in launches[300][2]}
    coarse = [r for r in records["K2"] if r["case"] == "K2 order 32 75x75 f32 (coarse solve)"][0]
    roofline_path = "roofline program (phase 13; launches captured in CUDA graphs)"
    print(json.dumps({"kernels": [
        report("K1", "gmres_tpu_torch/csrc/stencil5.cu",
               "gmres_tpu/ops/stencil.py:139", ["gmres_tpu/ops/stencil.py:206"],
               mg_k1 + strong["K1"] + roof["K1"], "K1 2048x2048 f32",
               launches_by_path={"mg (phase 4)": mg_k1,
                                 "strong-scaling (phase 12)": strong["K1"],
                                 roofline_path: roof["K1"]}),
        report("K2", "gmres_tpu_torch/csrc/chebk.cu",
               "gmres_tpu/ops/fused.py:187", ["gmres_tpu/ops/fused.py:388"],
               mg_k2 + roof["K2"], "K2 order 3 2048x2048 f32",
               launches_by_path=mg_k2_paths,
               launches_by_program={"mg (phase 4)": mg_k2, roofline_path: roof["K2"]},
               path=[r["path"] for r in records["K2"]
                     if r["case"] == "K2 order 3 2048x2048 f32"][0],
               sweep_path_ms=[r["sweep_ms"] for r in records["K2"]
                              if r["case"] == "K2 order 3 2048x2048 f32"][0],
               coarse_timed_at=coarse["case"], coarse_path=coarse["path"],
               coarse_ms=coarse["ms"], coarse_plain_ms=coarse["plain_ms"],
               coarse_sweep_path_ms=coarse["sweep_ms"], coarse_bound_ms=coarse["bound_ms"],
               coarse_bound_by=coarse["bound_by"]),
        report("K3", "gmres_tpu_torch/csrc/dia_spmv.cu",
               "gmres_tpu/ops/sparse.py:567", [], launches["K3"],
               f"K3 HYB {CG_GRIDS[-1]}x{CG_GRIDS[-1]} f64"),
        report("K4", "gmres_tpu_torch/csrc/bsr_spmv.cu",
               "gmres_tpu/ops/sparse.py:488", [], launches["K4"],
               f"K4 {BSR_CASES[-1][0]} f32"),
        report("K5", "gmres_tpu_torch/csrc/cheb2_fused.cu",
               "gmres_tpu/ops/fused.py:129", [], strong["K5"],
               f"K5 {STRONG_N}x{STRONG_N} f64 zero halo rows"),
        report("K7a", "gmres_tpu_torch/csrc/cg_fused.cu",
               "gmres_tpu/ops/fused.py:50", [], k7_launches[0],
               f"K7a {STRONG_N}x{STRONG_N} f64",
               launched_by="phase 11 per-shard call; no solver calls it, as in gmres_tpu"),
        report("K7b", "gmres_tpu_torch/csrc/cg_fused.cu",
               "gmres_tpu/ops/fused.py:94", [], k7_launches[1],
               f"K7b {STRONG_N}x{STRONG_N} f64",
               launched_by="phase 11 per-shard call; no solver calls it, as in gmres_tpu"),
        report("K6", "gmres_tpu_torch/csrc/stencil5_dd.cu",
               "gmres_tpu/ops/stencil.py:388", ["gmres_tpu/ops/stencil.py:519"],
               roof["K6"], f"K6 {ROOFLINE_GRIDS[-1]}x{ROOFLINE_GRIDS[-1]} poisson",
               launched_by=roofline_path,
               library_note="no PyTorch call computes the stencil on (hi, lo) "
               "pairs; nearest_library_ms is the float64 cross as one F.conv2d",
               nearest_library_ms=[r["nearest_library_ms"] for r in records["K6"]
                                   if "nearest_library_ms" in r][-1]),
        report("K8", "gmres_tpu_torch/csrc/stencil5_rdma.cu",
               "gmres_tpu/ops/stencil_rdma.py:41", [], k8["interior"],
               f"K8 {STRONG_N}x{STRONG_N} f32 operator zero halo rows",
               launches_by_path={"rdma gmres and cg (phase 14), interior": k8["interior"]},
               edge_launches=k8["edges"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
