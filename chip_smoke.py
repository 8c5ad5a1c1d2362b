#!/usr/bin/env python3
"""Smoke run of gmres_tpu_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100 (the kernels are
built for sm_90a). It imports torch, numpy and gmres_tpu_torch only.
Phases:

1. Require CUDA (exit non-zero without it); print the card's name and
   power limit as nvidia-smi reports them.
2. Build the CUDA kernels from gmres_tpu_torch/csrc with nvcc; print the
   build time and ptxas's resource report.
3. Compare kernel K1 (5-point stencil) and kernel K2 (order-k polynomial
   smoother) with their plain PyTorch versions on the card, at the shapes
   the main path gives them; print the error against a tolerance stated
   per case, and each kernel's and plain version's time (CUDA events,
   after a warm-up).
4. Solve the multigrid ``mg`` configuration (Householder GMRES, m=10,
   float32 Arnoldi cycles certified on the float64 true residual) at 300²
   and 2048²; check convergence with a float64 true residual computed
   independently in numpy, and that K1 and K2 were launched during the
   solves; profile one more solve of each (device time by kernel, and the
   device's busy share of the wall time).
5. Solve the reference configuration at 300² (float64, cbpr2, m=50).
6. At 64², check that the GPU solve and the port's CPU solve agree.

Any failure raises and exits non-zero. The line before the last is the
kernel report (JSON); the last line is the result (JSON).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
TOL = 1e-8
SOLVE_REPEATS = 11
# Inner iterations of the reference configuration at 300² recorded by the
# JAX package (BENCH_r05.json, decomposition, CPU run).
JAX_REFERENCE_INNER = 1200


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


def compare(name, kernel, plain, rtol, reps):
    """Run kernel and plain version on the same inputs; return a record."""
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
    }
    print(f"  {name:42s} rel_err {rel:.3e} (tol {rtol:.0e})  device: kernel "
          f"{rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms  eager call: "
          f"kernel {rec['call_ms']:.4f} ms plain {rec['plain_call_ms']:.4f} ms",
          flush=True)
    require(rel <= rtol, f"{name}: kernel disagrees with plain version "
            f"(rel err {rel:.3e} > {rtol:.0e})")
    return rec


def phase_kernels(gt_torch, rng):
    import numpy as np
    import torch

    from gmres_tpu_torch.ops import fused, stencil

    dev = torch.device("cuda", 0)
    sizes = (300, 150, 75, 1024, 2048)
    records = {"K1": [], "K2": []}
    print("phase 3: kernels against their plain versions", flush=True)
    coefs = (4.0, -1.0, -1.0, -1.0, -1.0)
    for n in sizes:
        reps = 200 if n <= 300 else 50
        for dt, rtol in ((torch.float32, 1e-6), (torch.float64, 1e-14)):
            tag = "f32" if dt == torch.float32 else "f64"
            x = torch.as_tensor(rng.standard_normal((n, n))).to(dev, dt)
            top = torch.as_tensor(rng.standard_normal(n)).to(dev, dt)
            bot = torch.as_tensor(rng.standard_normal(n)).to(dev, dt)
            records["K1"].append(compare(
                f"K1 {n}x{n} {tag}",
                lambda: stencil.stencil5_cuda(x, None, None, coefs),
                lambda: stencil.stencil_5pt_general(x, *coefs), rtol, reps))
            records["K1"].append(compare(
                f"K1 {n}x{n} {tag} halo rows",
                lambda: stencil.stencil5_cuda(x, top, bot, coefs),
                lambda: stencil.stencil_5pt_halo(x, top, bot, coefs),
                rtol, reps))
            # Order-3 smoother on [2, 8]: the V-cycle's pre/post smoother.
            theta, _, steps = fused.chebyshev_k_scalars(2.0, 8.0, 3)
            records["K2"].append(compare(
                f"K2 order 3 {n}x{n} {tag}",
                lambda: fused.chebk_cuda(x, theta, steps, coefs),
                lambda: fused.poly_stencil_smoother_plain(x, theta, steps, coefs),
                1e-5 if dt == torch.float32 else 1e-13, reps))
    for n in (75, 16):
        lam_min = 8.0 * np.sin(np.pi / (2 * (n + 1))) ** 2
        theta, _, steps = fused.chebyshev_k_scalars(lam_min, 8.0, 32)
        for dt, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-11)):
            tag = "f32" if dt == torch.float32 else "f64"
            r = torch.as_tensor(rng.standard_normal((n, n))).to(dev, dt)
            records["K2"].append(compare(
                f"K2 order 32 {n}x{n} {tag} (coarse solve)",
                lambda: fused.chebk_cuda(r, theta, steps, coefs),
                lambda: fused.poly_stencil_smoother_plain(r, theta, steps, coefs),
                rtol, 200))
    # Damped Jacobi on a general (non-symmetric) stencil, per-sweep path.
    gcoefs = (4.0, -1.2, -0.8, -1.1, -0.9)
    theta, steps = fused.jacobi_k_scalars(0.7, gcoefs[0], 8)
    r = torch.as_tensor(rng.standard_normal((300, 300))).to(dev, torch.float32)
    records["K2"].append(compare(
        "K2 Jacobi order 8 300x300 f32 general coefs",
        lambda: fused.chebk_cuda(r, theta, steps, gcoefs),
        lambda: fused.poly_stencil_smoother_plain(r, theta, steps, gcoefs),
        1e-5, 200))
    return records


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

    # Phase 3: kernels against their plain versions.
    rng = np.random.default_rng(SEED)
    records = phase_kernels(gt_torch, rng)

    # Phase 4: the mg configuration on the main path.
    launches = {}
    for n in (300, 2048):
        b_np, m_inv, solve = mg_solve(gt_torch, n, dev)
        res, t_warm = timed(solve)  # warm-up
        stencil.stencil5_cuda.launches = 0
        fused.chebk_cuda.launches = 0
        times = []
        for _ in range(SOLVE_REPEATS):
            res, t_solve = timed(solve)
            times.append(t_solve)
        k1, k2 = stencil.stencil5_cuda.launches, fused.chebk_cuda.launches
        launches[n] = (k1, k2)
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
              f"launches over the {SOLVE_REPEATS} solves: K1 {k1}, K2 {k2}",
              flush=True)
        profile_solve(solve, f"mg {n}x{n}", float(np.median(times)))
        require(res.status == 0, f"mg {n}: not converged (status {res.status})")
        require(rel <= TOL, f"mg {n}: true relative residual {rel:.3e} > {TOL}")
        require(k1 > 0 and k2 > 0, f"mg {n}: K1/K2 not launched ({k1}, {k2})")
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

    def report(name, recs, src, replaces, also, k):
        big = [r for r in recs if r["case"].startswith(f"{name} 2048x2048 f32")
               or r["case"].startswith(f"{name} order 3 2048x2048 f32")][0]
        return {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "also_replaces": also,
            "launches": launches[2048][k] + launches[300][k],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": big["ms"], "plain_ms": big["plain_ms"],
            "timed_at": big["case"],
        }

    print(json.dumps({"kernels": [
        report("K1", records["K1"], "gmres_tpu_torch/csrc/stencil5.cu",
               "gmres_tpu/ops/stencil.py:139", ["gmres_tpu/ops/stencil.py:206"],
               0),
        report("K2", records["K2"], "gmres_tpu_torch/csrc/chebk.cu",
               "gmres_tpu/ops/fused.py:187", ["gmres_tpu/ops/fused.py:388"], 1),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
