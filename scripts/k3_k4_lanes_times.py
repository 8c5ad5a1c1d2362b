#!/usr/bin/env python3
"""Device time of kernels K3 and K4, on one vector and on lane blocks, as one
tree's package launches them, for comparing two trees on one card.

    python3 scripts/k3_k4_lanes_times.py [--root DIR] [--label NAME]
        [--repeats N] [--out FILE]

Imports ``gmres_tpu_torch`` from DIR (default: the checkout holding this
script), builds its kernels and times, each N times (device ms of one call
by CUDA-graph replay, chip_smoke.py's ``device_ms``), on inputs made on the
card from one seed:

* K3 on the DIA of HYB 1000² float64 (the cg path's matrix): one vector,
  and blocks of 4, 8 and 9 lanes; cuSPARSE's CSR product on x and on
  X = (n, lanes) beside each;
* K4 on 512 block rows of three 128² blocks: one vector float32 and
  float64, blocks of 4, 8, 9 and 16 lanes float32 and 8 lanes float64;
  cuSPARSE's BSR product on x and on X = (n, lanes) beside each.

Every lane block is first held bitwise to its lanes' single launches. It
prints one line a case and, last, one JSON line: the card's name and power
limit, and per case the median and quartiles of the N times and of the
library call's (eager calls between CUDA events), and the SHA-256 of the
kernel's output bytes, which two trees given the same inputs compare.
``--out`` appends the JSON line to FILE as well (and, where this run built the
kernels, ptxas's report on K3's and K4's sources to FILE.NAME.ptxas.txt).

The kernels' entry points keep their signatures across the trees compared,
so the same script times both. To compare trees, run it on each in turns (A,
B, B, A) in one call, on one card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261018
K3_N = 1000
K3_LANES = (4, 8, 9)
K4_SHAPE = (512, 128)          # block rows, block size; three blocks a row
K4_LANES = (("float32", 4), ("float32", 8), ("float32", 9), ("float32", 16),
            ("float64", 8))


def _smoke():
    """chip_smoke.py of this script's checkout (its timing helpers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spread(times) -> dict:
    q = statistics.quantiles(times, n=4) if len(times) > 1 else [times[0]] * 3
    return {"median": statistics.median(times), "q1": q[0], "q3": q[2], "all": times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout to import the package from")
    ap.add_argument("--label", default="", help="name of the tree in the output")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=None, help="file to append the JSON line to")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k3_k4_lanes_times: needs a CUDA device", file=sys.stderr)
        return 1
    smoke = _smoke()
    sys.path.insert(0, os.path.abspath(args.root))
    import gmres_tpu_torch as gtt
    from gmres_tpu_torch.ops import _cuda, sparse

    if not os.path.abspath(gtt.__file__).startswith(os.path.abspath(args.root)):
        raise RuntimeError(f"gmres_tpu_torch imported from {gtt.__file__}")
    _cuda.load()
    ptxas = [sec.strip() for sec in _cuda.build_log.split("== ")[1:]
             if sec.startswith(("bsr_spmv.cu", "dia_spmv.cu"))]
    for line in "\n".join(ptxas).splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    if args.out and ptxas:
        with open(f"{args.out}.{args.label or 'tree'}.ptxas.txt", "w") as f:
            f.write("\n\n".join(ptxas) + "\n")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    out = {"label": args.label, "root": os.path.abspath(args.root), "card": smi,
           "cases": {}}
    print(f"k3_k4_lanes_times {args.label}: {smi}", flush=True)

    def timed(name, fn, library, reps, per_graph=10, **extra):
        y = fn()
        torch.cuda.synchronize()
        extra["y_sha256"] = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
        ms = [smoke.device_ms(fn, reps, per_graph) for _ in range(args.repeats)]
        lib = [smoke.call_ms(library, reps) for _ in range(args.repeats)]
        rec = {"ms": _spread(ms), "library_ms": _spread(lib), **extra}
        out["cases"][name] = rec
        print(f"  {name:44s} {rec['ms']['median']:.4f} ms ({rec['ms']['q1']:.4f}-"
              f"{rec['ms']['q3']:.4f}); library {rec['library_ms']['median']:.4f} ms",
              flush=True)

    def bitwise(name, batched, single, xb):
        y = batched()
        torch.cuda.synchronize()
        for k in range(xb.shape[0]):
            if not torch.equal(y[k], single(xb[k])):
                raise RuntimeError(f"{name}: lane {k} differs from its single launch")

    # K3: the DIA of HYB 1000² float64.
    csr = gtt.poisson_csr(K3_N, device=dev)
    a3 = gtt.csr_to_hyb(csr).dia
    lib3 = smoke.csr_library(csr, torch.float64)
    n3 = K3_N * K3_N
    x3 = torch.randn(n3, generator=gen, device=dev, dtype=torch.float64)
    timed(f"K3 HYB {K3_N}x{K3_N} f64", lambda: sparse.dia_spmv_cuda(a3, x3),
          lambda: lib3 @ x3, 200)
    for lanes in K3_LANES:
        xb = torch.randn((lanes, n3), generator=gen, device=dev, dtype=torch.float64)
        xt = xb.T.contiguous()
        name = f"K3 batched HYB {K3_N}x{K3_N} f64 {lanes} lanes"
        bitwise(name, lambda: sparse.dia_spmv_cuda(a3, xb),
                lambda v: sparse.dia_spmv_cuda(a3, v), xb)
        timed(name, lambda: sparse.dia_spmv_cuda(a3, xb), lambda: lib3 @ xt, 100)

    # K4: 512 block rows of three 128² blocks.
    nbr, bs = K4_SHAPE
    base = smoke.block_tridiagonal(gtt, nbr, bs, torch.float64, dev, gen)
    mats = {}
    for dts in ("float32", "float64"):
        dt = getattr(torch, dts)
        a4 = gtt.BSRMatrix(data=base.data.to(dt), block_cols=base.block_cols,
                           shape=base.shape)
        mats[dts] = (a4, smoke.bsr_library(a4))
    n4 = nbr * bs
    a4, lib4 = mats["float32"]
    x4 = torch.randn(n4, generator=gen, device=dev, dtype=torch.float32)
    timed(f"K4 {nbr} block rows bs={bs} f32", lambda: sparse.bsr_spmv_cuda(a4, x4),
          lambda: lib4 @ x4, 50)
    a64, lib64 = mats["float64"]
    x64 = x4.double()
    timed(f"K4 {nbr} block rows bs={bs} f64", lambda: sparse.bsr_spmv_cuda(a64, x64),
          lambda: lib64 @ x64, 50)
    for dts, lanes in K4_LANES:
        a4, lib4 = mats[dts]
        dt = getattr(torch, dts)
        tag = "f32" if dts == "float32" else "f64"
        xb = torch.randn((lanes, n4), generator=gen, device=dev, dtype=dt)
        xt = xb.T.contiguous()
        name = f"K4 batched {nbr} block rows bs={bs} {tag} {lanes} lanes"
        bitwise(name, lambda: sparse.bsr_spmv_cuda(a4, xb),
                lambda v: sparse.bsr_spmv_cuda(a4, v), xb)
        timed(name, lambda: sparse.bsr_spmv_cuda(a4, xb), lambda: lib4 @ xt, 50,
              per_graph=2 if lanes >= 16 else 10)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
