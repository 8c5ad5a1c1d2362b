"""Result reporting: aligned text tables and JSONL rows.

Counterpart of ``gmres_tpu/utils/reporting.py``: the same record fields, the
same table columns and the same JSON keys, so that rows of the two packages
compare directly; ``record_from_result`` reads a result's tensors back
through ``.cpu().numpy()`` (a DTensor assembled first). Printing is gated to rank 0 of the process group when one
exists (a multi-process program prints once); without a group this process
is rank 0.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import Any, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def is_host0() -> bool:
    """True on rank 0 of the default process group, or when there is none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


@dataclasses.dataclass
class RunRecord:
    """One run's report row (the reference's print_results argument list
    plus throughput metrics)."""

    name: str
    nvars: int
    iterations: int
    restarts: Optional[int] = None
    tol: Optional[float] = None
    l2_error: Optional[float] = None
    linf_error: Optional[float] = None
    residual: Optional[float] = None
    v_err: Optional[float] = None
    wall_s: Optional[float] = None
    nnz: Optional[int] = None
    extra: Optional[dict] = None

    @property
    def nnz_per_s(self) -> Optional[float]:
        """Nonzeros touched per second over the run (one operator
        application per iteration unless extra['matvecs'] says otherwise)."""
        if not self.nnz or not self.wall_s:
            return None
        matvecs = (self.extra or {}).get(
            "matvecs", (self.extra or {}).get("total_iters", self.iterations))
        return self.nnz * matvecs / self.wall_s

    @property
    def iters_per_s(self) -> Optional[float]:
        if not self.wall_s:
            return None
        total = (self.extra or {}).get("total_iters", self.iterations)
        return total / self.wall_s

    def to_json(self) -> dict:
        d = {k: v for k, v in dataclasses.asdict(self).items()
             if v is not None and k != "extra"}
        if self.nnz_per_s is not None:
            d["nnz_per_s"] = self.nnz_per_s
        if self.iters_per_s is not None:
            d["iters_per_s"] = self.iters_per_s
        if self.extra:
            d.update(self.extra)
        return d


def _numpy(t) -> np.ndarray:
    """A result field as numpy: a DTensor assembled, a tensor through
    ``.cpu().numpy()``."""
    if isinstance(t, torch.Tensor):
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        return t.detach().cpu().numpy()
    return np.asarray(t)


def record_from_result(
    name: str,
    result: Any,
    *,
    x_true=None,
    wall_s: Optional[float] = None,
    tol: Optional[float] = None,
    nnz: Optional[int] = None,
    extra: Optional[dict] = None,
) -> RunRecord:
    """A RunRecord from a SolveResult or GmresResult, with the
    manufactured-solution errors L2 = ‖x − x*‖₂ and L∞ = max|x − x*| of
    the reference programs, computed in numpy as gmres_tpu computes them."""
    x = _numpy(result.x)
    l2 = linf = None
    if x_true is not None:
        diff = x - _numpy(x_true)
        l2 = float(np.linalg.norm(diff.ravel()))
        linf = float(np.max(np.abs(diff)))
    v_err = None
    if hasattr(result, "v_err"):
        v = _numpy(result.v_err)
        v_err = float(np.max(v)) if v.size else None
    return RunRecord(
        name=name,
        nvars=int(x.size),
        iterations=int(result.iterations),
        restarts=int(result.restarts) if hasattr(result, "restarts") else None,
        tol=tol,
        l2_error=l2,
        linf_error=linf,
        residual=float(result.residual),
        v_err=v_err,
        wall_s=wall_s,
        nnz=nnz,
        extra=extra,
    )


_COLUMNS = (
    ("name", "{:<26}", 26),
    ("nvars", "{:>9}", 9),
    ("iterations", "{:>6}", 6),
    ("restarts", "{:>5}", 5),
    ("residual", "{:>10.2e}", 10),
    ("l2_error", "{:>10.2e}", 10),
    ("linf_error", "{:>10.2e}", 10),
    ("v_err", "{:>10.2e}", 10),
    ("wall_s", "{:>9.3f}", 9),
)
_HEADS = ("solver", "vars", "iters", "rst", "residual", "L2", "Linf",
          "|I-VtV|", "time[s]")


def print_line(file=None) -> None:
    if not is_host0():
        return
    total = sum(w for _, _, w in _COLUMNS) + 2 * (len(_COLUMNS) - 1)
    print("-" * total, file=file or sys.stdout)


def print_header(file=None) -> None:
    if not is_host0():
        return
    out = file or sys.stdout
    print_line(out)
    print("  ".join(h.ljust(w) if i == 0 else h.rjust(w)
                    for i, (h, (_, _, w)) in enumerate(zip(_HEADS, _COLUMNS))),
          file=out)
    print_line(out)


def print_results(record: RunRecord, file=None) -> None:
    """One aligned row."""
    if not is_host0():
        return
    cells = []
    for field, fmt, width in _COLUMNS:
        val = getattr(record, field)
        if val is None or (isinstance(val, float) and math.isnan(val)):
            cells.append("-".rjust(width) if field != "name" else "-".ljust(width))
        else:
            cells.append(fmt.format(val))
    print("  ".join(cells), file=file or sys.stdout)


def print_table(records: Sequence[RunRecord], file=None) -> None:
    """Header, rows and a closing line."""
    print_header(file)
    for r in records:
        print_results(r, file)
    print_line(file)


def write_jsonl(records: Iterable[RunRecord], path: str,
                append: bool = False) -> None:
    """Write the records to JSONL, one object a line; rank 0 only."""
    if not is_host0():
        return
    with open(path, "a" if append else "w") as f:
        for r in records:
            f.write(json.dumps(r.to_json()) + "\n")
