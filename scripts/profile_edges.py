#!/usr/bin/env python3
"""How often torch.profiler loses a profiled call's device kernels, with and
without host time between the recorded step's edges and the call.

    python3 scripts/profile_edges.py [--procs P] [--rounds R]

Profiles two calls on the card, one elementwise kernel and a chain of 100,
R times each for every gap in GAPS_S, through chip_smoke.py's ``profiled``
(a warm-up step, then a recorded step that opens and closes with spin
kernels; the gap is its ``edge``, host seconds slept after the opening
spin kernels and before the closing ones), and counts the profiles that
report fewer kernels than the call launched. With ``--procs P`` it runs P
copies of itself at once on the one card, as chip_smoke.py's worker
processes do. Each process prints one JSON line: the card's name and power
limit, and per (call, gap) the profiles short of their kernels and the
fewest kernels seen.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GAPS_S = (0.0, 0.005, 0.05)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=25)
    args = ap.parse_args()
    if args.procs > 1:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--rounds", str(args.rounds)])
                 for _ in range(args.procs)]
        return max(p.wait() for p in procs)
    import torch

    from chip_smoke import kernel_counts, profiled

    if not torch.cuda.is_available():
        print("profile_edges: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    x = torch.randn(1 << 20, device="cuda")

    def chain():
        y = x
        for _ in range(100):
            y = y + 1
        return y

    calls = {"1 kernel": (lambda: x + 1, 1), "100 kernels": (chain, 100)}
    seen = {}
    for _ in range(args.rounds):
        for name, (fn, _) in calls.items():
            for gap in GAPS_S:
                events = profiled(fn, edge=gap)[2]
                seen.setdefault((name, gap), []).append(kernel_counts(events)[0])
    rows = [{"call": name, "gap_s": gap, "profiles": len(v),
             "short": sum(c < calls[name][1] for c in v), "fewest": min(v)}
            for (name, gap), v in seen.items()]
    print(json.dumps({"card": smi, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
