#!/usr/bin/env python3
"""Walls, launches and a profile of the block rows as one tree's package runs
them, for comparing two trees (or a block application's two forms) on one
card.

    python3 scripts/block_rows_times.py [--root DIR] [--label NAME]
        [--repeats N] [--loop]

Imports ``gmres_tpu_torch`` from DIR (default: the checkout holding this
script), builds its kernels and runs chip_smoke.py's block rows on
Poisson 512² with its multigrid V-cycle as M: block CG at s = 4 (tol 1e-8)
and block GMRES(30) at s = 4 (tol 1e-8), b = A x for seeded x. Each row
runs once untimed, then N timed solves (the host clock around a solve and
a synchronisation), then one solve under torch.profiler. It prints one
JSON line: the card's name and power limit, and per row the iterations,
the walls, the kernel launches of one solve by counter, and the profile's
device busy ms, kernels, and host ms in aten ops by op (the 12
largest).

``--loop`` replaces ``ops/blas.py:row_apply`` in every module of the
package that imported it with the loop of one application a row (the
form a tree without vmap's batched block applications has), so that a
tree's vmap and loop forms can be compared in one process. To compare
trees, run it on each in turns (A, B, B, A) in one call, on one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """chip_smoke.py of this script's checkout (its numpy stencil and
    profile helpers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _launches(stencil, fused) -> dict:
    """Every launch counter of K1's forms and K2 the tree has (a tree
    without batched wrappers has fewer)."""
    out = {}
    for mod in (stencil, fused):
        for name in ("stencil5_cuda", "residual_restrict_cuda", "correct_residual_cuda",
                     "chebk_cuda", "stencil5_batched_cuda", "residual_restrict_batched_cuda",
                     "correct_residual_batched_cuda", "chebk_batched_cuda"):
            fn = getattr(mod, name, None)
            if fn is None:
                continue
            for attr in ("launches", "batched_launches"):
                if hasattr(fn, attr):
                    out[f"{name}.{attr}"] = getattr(fn, attr)
    return out


def _loop_row_apply(pkg) -> int:
    """Point every module's ``row_apply`` at the loop; returns how many."""
    from gmres_tpu_torch.ops import blas

    import torch

    def loop(fn, rows):
        return torch.stack([fn(rows[i]) for i in range(rows.shape[0])])

    vmapped = blas.row_apply
    patched = 0
    for name, mod in list(sys.modules.items()):
        if name.startswith(pkg.__name__) and getattr(mod, "row_apply", None) is vmapped:
            mod.row_apply = loop
            patched += 1
    return patched


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout to import the package from")
    ap.add_argument("--label", default="", help="name of the tree in the output")
    ap.add_argument("--repeats", type=int, default=9, help="timed solves a row")
    ap.add_argument("--loop", action="store_true",
                    help="apply a block one row at a time (row_apply as a loop)")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("block_rows_times: needs a CUDA device", file=sys.stderr)
        return 1
    smoke = _smoke()
    sys.path.insert(0, os.path.abspath(args.root))
    import gmres_tpu_torch as gt
    from gmres_tpu_torch.ops import _cuda, fused, stencil

    _cuda.load()
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    patched = _loop_row_apply(gt) if args.loop else 0
    dev = torch.device("cuda", 0)
    n, s = 512, 4
    op = gt.poisson_operator(n)
    m_inv = gt.poisson_multigrid_preconditioner(n)
    xs = np.random.default_rng(0).standard_normal((s, n, n))
    b = torch.as_tensor(np.stack([smoke.np_stencil(x) for x in xs]), device=dev)
    rows = {
        "block_cg s=4 mg 512": lambda: gt.block_cg(op, b, tol=1e-8, M=m_inv,
                                                   max_iterations=2000),
        "block_gmres(30) s=4 mg 512": lambda: gt.block_gmres(op, b, restart=30, tol=1e-8,
                                                             M=m_inv, max_restarts=200),
    }
    out = {"label": args.label, "root": os.path.abspath(args.root), "card": smi,
           "torch": torch.__version__, "loop": args.loop, "modules_patched": patched,
           "rows": {}}
    for label, solve in rows.items():
        res = solve()
        torch.cuda.synchronize()
        before = _launches(stencil, fused)
        walls = []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        after = _launches(stencil, fused)
        per_solve = {k: (after[k] - before[k]) / args.repeats for k in after}
        _, wall, events = smoke.profiled(solve)
        busy_ms = sum(e.self_device_time_total for e in smoke.device_kernels(events)) / 1e3
        kernels, copies = smoke.kernel_counts(events)
        host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events
                       if e.device_type == DeviceType.CPU and e.key.startswith("aten::")),
                      key=lambda t: -t[1])
        aten_ms = sum(t[1] for t in host)
        out["rows"][label] = {
            "iterations": int(getattr(res, "iterations", 0)),
            "restarts": int(getattr(res, "restarts", 0)),
            "walls_s": walls, "median_s": float(np.median(walls)),
            "min_s": min(walls), "launches_per_solve": per_solve,
            "profile": {"wall_ms": wall * 1e3, "busy_ms": busy_ms, "kernels": kernels,
                        "copies": copies, "aten_self_host_ms": aten_ms,
                        "aten_calls": sum(t[2] for t in host),
                        "top_host_ops": [[k, round(ms, 3), c] for k, ms, c in host[:12]]},
        }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
