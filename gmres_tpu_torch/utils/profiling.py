"""Profiling and roofline helpers.

Counterpart of ``gmres_tpu/utils/profiling.py``: a profiler trace around any
block, and the achieved bandwidth of a chained function against the card's
HBM peak.

``measure_bandwidth`` chains x ← fn(x) at two chain lengths and takes the
slope, so the fixed cost of starting a chain cancels. On the card one chain
is captured in one CUDA graph and replayed between CUDA events: the
counterpart of JAX's chain inside one ``jit`` call, without which a chain
of small kernels measures the host's launch rate. Every function the port's
programs time is capturable (PyTorch operations and kernel launches on the
current stream, outputs from ``torch.empty``, no reads on the host), so a
CUDA chain is always captured and the record says so under ``timing``. On
the CPU the chain runs eagerly under the host clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch

# Peak HBM bandwidth (GB/s) by the card's name (torch.cuda.get_device_name);
# used only for a fraction-of-peak estimate. Other cards report the achieved
# number with fraction None. H100 SXM: NVIDIA's data sheet, at 700 W.
_HBM_PEAK_GBPS = {
    "H100 80GB HBM3": 3350.0,
}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (the host, and the card where
    there is one) and write a Chrome trace, ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _device_peak_gbps(device=None) -> Optional[float]:
    """The HBM peak of ``device`` (default: the current CUDA device), or
    None for the CPU and for a card not in the table."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in _HBM_PEAK_GBPS.items():
        if key in name:
            return peak
    return None


def _leaves(x) -> list:
    """The tensors of x: a tensor, or a tuple of them such as a (hi, lo) pair."""
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _chain(fn: Callable, x, k: int):
    for _ in range(k):
        x = fn(x)
    return x


def _graph_seconds(fn: Callable, x, k: int, replays: int = 3) -> float:
    """Device seconds of k chained calls: captured in one CUDA graph, the
    least of ``replays`` replays between CUDA events."""
    device = _leaves(x)[0].device
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _chain(fn, x, 1)  # builds the kernels and warms the allocator
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            out = _chain(fn, x, k)
        graph.replay()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(replays):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        del out, graph
        return best


def _host_seconds(fn: Callable, x, k: int) -> float:
    """Host seconds of k chained calls on the CPU: the least of two runs
    after a warm-up."""
    _chain(fn, x, k)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        _chain(fn, x, k)
        best = min(best, time.perf_counter() - t0)
    return best


def measure_bandwidth(fn: Callable, x, bytes_moved: int, reps: int = 50) -> dict:
    """Achieved effective bandwidth of fn(x) (GB/s): the time of one
    application is the slope between chains of ``reps`` and ``2·reps``
    applications of x ← fn(x). ``fn`` maps x to the same structure: a tensor,
    or a tuple of tensors such as a (hi, lo) pair."""
    device = _leaves(x)[0].device
    on_card = device.type == "cuda"
    total = _graph_seconds if on_card else _host_seconds
    r1 = max(1, reps)
    r2 = 2 * r1
    dt = max((total(fn, x, r2) - total(fn, x, r1)) / (r2 - r1), 1e-9)
    gbps = bytes_moved / dt / 1e9
    peak = _device_peak_gbps(device)
    return {
        "seconds": dt,
        "gbps": gbps,
        "fraction_of_peak": (gbps / peak) if peak else None,
        "peak_gbps": peak,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "timing": ("CUDA graph of each chain, CUDA events" if on_card
                   else "host clock"),
    }


def stencil_roofline(nsize: int, dtype=torch.float32, reps: int = 50,
                     device="cuda") -> dict:
    """Roofline check of the plain 5-point stencil on ``device`` (the card
    unless the caller asks for the CPU): it reads and writes one grid each,
    an ideal traffic of 2·N²·itemsize."""
    from gmres_tpu_torch.ops.stencil import stencil_5pt_apply

    x = torch.ones((nsize, nsize), dtype=dtype, device=device)
    out = measure_bandwidth(stencil_5pt_apply, x, 2 * x.numel() * x.element_size(),
                            reps)
    out["kernel"] = "stencil_5pt_plain"
    out["nsize"] = nsize
    out["dtype"] = str(dtype)
    return out
