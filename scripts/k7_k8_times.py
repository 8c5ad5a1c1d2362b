#!/usr/bin/env python3
"""Device time of kernels K7 and K8 as one tree's package launches them, for
comparing two trees on one card.

    python3 scripts/k7_k8_times.py [--root DIR] [--label NAME]

Imports ``gmres_tpu_torch`` from DIR (default: the checkout holding this
script), builds its kernels, makes a one-rank NCCL group on a file
rendezvous, and prints one JSON line: the card's name and power limit, and
per case the device ms of one call by CUDA-graph replay (10 calls a graph,
chip_smoke.py's ``device_ms``) and the host µs to enqueue one call:

* K7a (``cg_fused_update``) and K7b (``axpy_dot``) at 304² float64 and
  2048² float32, α a 0-d tensor on the card for the device times (a Python
  α cannot be captured where the wrapper copies it to the card) and a
  Python float for the host times;
* K8 through ``stencil_5pt_rdma`` (one application as the RDMA operator
  and cbpr2 run it) at 304² float32, and the operator at 2048² float32
  cycling through 4 input sets (more than the 50 MB L2).

``stencil_5pt_rdma`` and the K7 entry points keep their signatures across
the trees compared, so the same script times both. To compare trees, run
it on each in turns (A, B, B, A) in one call, on one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """chip_smoke.py of this script's checkout (its timing helpers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout to import the package from")
    ap.add_argument("--label", default="", help="name of the tree in the output")
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("k7_k8_times: needs a CUDA device", file=sys.stderr)
        return 1
    smoke = _smoke()
    sys.path.insert(0, os.path.abspath(args.root))
    import gmres_tpu_torch as gtt
    from gmres_tpu_torch.ops import _cuda, fused
    from gmres_tpu_torch.ops import stencil_rdma as rd

    if not os.path.abspath(gtt.__file__).startswith(os.path.abspath(args.root)):
        raise RuntimeError(f"gmres_tpu_torch imported from {gtt.__file__}")
    _cuda.load()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(20261017)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    out = {"label": args.label, "root": os.path.abspath(args.root), "card": smi}

    def vec(n, dt):
        return torch.as_tensor(rng.standard_normal((n, n))).to(dev, dt)

    for n, dt in ((304, torch.float64), (2048, torch.float32)):
        x, r, p, q = (vec(n, dt) for _ in range(4))
        a = torch.tensor(0.37, dtype=dt, device=dev)
        tag = f"{n}x{n} {'f64' if dt == torch.float64 else 'f32'}"
        reps = 200 if n <= 304 else 50
        out[f"K7a {tag}"] = {
            "ms": smoke.device_ms(lambda: fused.cg_fused_update_cuda(x, r, p, q, a), reps),
            "host_us": smoke.host_us(lambda: fused.cg_fused_update_cuda(x, r, p, q, 0.37))}
        out[f"K7b {tag}"] = {
            "ms": smoke.device_ms(lambda: fused.axpy_dot_cuda(a, x, r, p), reps),
            "host_us": smoke.host_us(lambda: fused.axpy_dot_cuda(0.37, x, r, p))}

    d, alpha = fused.chebyshev_ref_scalars(0.2, 8.2)
    coefs = (4.0, -1.0, -1.0, -1.0, -1.0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                                rank=0, world_size=1)
        try:
            for n, form, ab, sets in ((304, "operator", (0.0, 1.0), 1),
                                      (304, "cbpr2", (1.0 / d + alpha, -alpha / d), 1),
                                      (2048, "operator", (0.0, 1.0), 4)):
                xs = [vec(n, torch.float32) for _ in range(sets)]
                calls = [lambda x=x: rd.stencil_5pt_rdma(x, (*coefs, *ab)) for x in xs]
                it = itertools.cycle(calls)
                out[f"K8 {n}x{n} f32 {form}"] = {
                    "ms": smoke.device_ms(lambda: next(it)(), 200 if n <= 304 else 50),
                    "host_us": smoke.host_us(calls[0]), "input_sets": sets}
        finally:
            dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
