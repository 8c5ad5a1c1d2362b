"""Driver programs of the PyTorch/CUDA port, as one CLI.

Counterpart of ``benchmarks/cli.py``, which has a subcommand for each
reference program. Ported so far:

  roofline   achieved bandwidth of the stencil routes (plain float32 and
             float64, kernel K1, kernel K6 on (hi, lo) pairs), of the
             order-k Chebyshev smoother (kernel K2) and of the multigrid
             V-cycle, against the card's HBM peak

Usage: python -m gmres_tpu_torch.benchmarks <subcommand> [options]

Every subcommand runs on the card unless ``--device cpu`` is given, and
raises where there is no card and no such flag. It prints the
reference-style table and can append its rows to JSONL (``--jsonl PATH``).
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from gmres_tpu_torch.utils.reporting import RunRecord, is_host0, print_table, write_jsonl

# The card's L2 (H100: 50 MB). A chained row whose working set fits there
# re-reads its data from L2, not from HBM.
L2_BYTES = 50 * 2**20
# A row may exceed the HBM peak by measurement noise; beyond this it must
# carry a stated traffic model.
PEAK_SLACK = 1.05


def _emit(records, args):
    print_table(records)
    if getattr(args, "jsonl", None):
        write_jsonl(records, args.jsonl, append=True)


def _device(args) -> torch.device:
    """The device a program runs on: the card unless --device cpu."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's programs run on the "
                           "card; pass --device cpu for the plain versions "
                           "on the CPU")
    return torch.device(args.device)


def cmd_roofline(args):
    """Achieved bandwidth (slope-timed chains, utils/profiling.py's
    measure_bandwidth) of the stencil routes, the order-k smoother and the
    multigrid V-cycle, with fraction-of-peak columns.

    Traffic: every row's bytes_moved is the IDEAL read-x + write-y traffic
    of one application (2·N²·itemsize; a (hi, lo) pair moves the bytes of
    float64; the V-cycle's is fine_equiv_sweeps × that; the smoother's
    (order − 1) × that, the work of as many plain stencil sweeps).

    L2 residency: the chain re-applies fn to its own output, so when the
    working set (two copies of x) fits in the card's 50 MB L2 the reps after
    the first barely touch HBM: such rows are flagged ``l2_resident`` with
    a note (float32 1024² and 2048², float64 and pairs 1024²), and so is any
    row above the peak that carries no other traffic model. The honest HBM
    rows are float32 4096² and float64 and pairs 2048² and 4096². The kernel
    rows (K1, K6, K2) run on the card only, as JAX's run on the TPU only."""
    from gmres_tpu_torch.ops.dd import dd_from_f64
    from gmres_tpu_torch.ops.fused import (
        chebyshev_blocked_feasible,
        chebyshev_k_poisson_pallas_blocked,
    )
    from gmres_tpu_torch.ops.stencil import (
        stencil_5pt_apply,
        stencil_5pt_dd_pallas_blocked,
        stencil_5pt_pallas_blocked,
        stencil_blocked_feasible,
    )
    from gmres_tpu_torch.precond.multigrid import poisson_multigrid_preconditioner
    from gmres_tpu_torch.utils.profiling import measure_bandwidth

    dev = _device(args)
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(0)
    records = []

    def bench(name, fn, x, traffic, extra=None):
        out = measure_bandwidth(fn, x, bytes_moved=traffic, reps=args.reps)
        leaves = list(x) if isinstance(x, tuple) else [x]
        nvars = max(t.numel() for t in leaves)
        e = {
            "matvecs": 1,
            "gbps": out["gbps"],
            "fraction_of_peak": out["fraction_of_peak"],
            "peak_gbps": out["peak_gbps"],
            "device": out["device"],
            "timing": out["timing"],
        }
        if extra:
            e.update(extra)
        working_set = 2 * sum(t.numel() * t.element_size() for t in leaves)
        if on_card and (
            working_set <= L2_BYTES
            or ((e["fraction_of_peak"] or 0) > PEAK_SLACK and "note" not in e)
        ):
            e["l2_resident"] = True
            e["l2_note"] = (
                "working set fits in the card's 50 MB L2: the chained reps "
                "re-use on-chip data, so this row measures L2 bandwidth, "
                "not HBM — read the largest grid for the HBM number"
            )
        records.append(RunRecord(name=name, nvars=nvars, iterations=1,
                                 wall_s=out["seconds"], nnz=5 * nvars, extra=e))

    for n in (int(s) for s in args.grids.split(",")):
        x64 = torch.as_tensor(rng.standard_normal((n, n))).to(dev)
        x32 = x64.to(torch.float32)
        t32 = 2 * x32.numel() * 4
        bench(f"stencil-plain-f32-{n}", stencil_5pt_apply, x32, t32)
        bench(f"stencil-plain-f64-{n}", stencil_5pt_apply, x64, 2 * x64.numel() * 8)
        if on_card and stencil_blocked_feasible(n):
            bench(f"stencil-pallas-blocked-f32-{n}", stencil_5pt_pallas_blocked,
                  x32, t32)
            # The float64 route on (hi, lo) float32 pairs, chained in pair
            # space (split once outside); hi + lo in and out moves the bytes
            # of the float64 row, so the fractions compare directly.
            bench(f"stencil-pallas-dd-f64-{n}",
                  lambda p: stencil_5pt_dd_pallas_blocked(p[0], p[1]),
                  dd_from_f64(x64), 2 * x64.numel() * 8,
                  extra={"note": "(hi, lo) float32 pairs, pair-space chain; "
                         "K6 works in native float64 (more accurate than the "
                         "TPU kernel's ~2^-48)"})
        k = args.cheb_order
        if on_card and chebyshev_blocked_feasible(n, k):
            bench(f"chebk{k}-blocked-f32-{n}",
                  lambda v, kk=k: chebyshev_k_poisson_pallas_blocked(v, kk, 0.005, 8.0),
                  x32, (k - 1) * t32,
                  extra={"sweeps_fused": k - 1,
                         "note": "traffic = (order-1) plain-equivalent sweeps; "
                         "K2 on a grid past shared memory runs one launch per "
                         "sweep, each reading r, z, d and writing z, d"})
        m_inv = poisson_multigrid_preconditioner(n)
        bench(f"mg-vcycle-f32-{n}", m_inv, x32,
              int(m_inv.fine_equiv_sweeps * t32),
              extra={"fine_equiv_sweeps": m_inv.fine_equiv_sweeps})
    _emit(records, args)
    # The table's seconds column hides microsecond kernels.
    if is_host0():
        print(f"{'row':<30} {'us/apply':>11} {'GB/s':>9} {'of peak':>8}  flags")
        for r in records:
            frac = r.extra["fraction_of_peak"]
            flags = " ".join(f for f in ("l2_resident", "note") if f in r.extra)
            print(f"{r.name:<30} {r.wall_s * 1e6:>11.3f} {r.extra['gbps']:>9.1f} "
                  f"{'-' if frac is None else f'{frac:.3f}':>8}  {flags}")
    return records


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gmres-tpu-torch-bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--jsonl", help="append rows to this JSONL file")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, fn, **defaults):
        sp_ = sub.add_parser(name)
        sp_.set_defaults(func=fn)
        # SUPPRESS: without it the subparser's default would clobber a
        # top-level --jsonl given before the subcommand.
        sp_.add_argument("--jsonl", default=argparse.SUPPRESS)
        sp_.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                         help="the card (default) or the CPU")
        for k, v in defaults.items():
            flag = "--" + k.replace("_", "-")
            if isinstance(v, bool):
                sp_.add_argument(flag, action="store_true")
            else:
                sp_.add_argument(flag, type=type(v), default=v)
        return sp_

    add("roofline", cmd_roofline, grids="1024,2048,4096", reps=20, cheb_order=8)
    return p


def main(argv: Optional[list] = None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    main()
