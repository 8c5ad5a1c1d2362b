"""The port's profiling helpers and its ``roofline`` program
(``gmres_tpu_torch.utils.profiling``, ``gmres_tpu_torch.benchmarks``)
against gmres_tpu's, on the CPU.

On the CPU the program runs the plain rows only (the kernel rows need the
card, as JAX's need the TPU) and times by the host clock; what it must share
with JAX's program is the rows, their fields and the traffic they count.
The card's numbers come from chip_smoke.py, phase 13.
"""

import json

import numpy as np
import pytest
import torch

from benchmarks.cli import main as jax_main
from gmres_tpu_torch.benchmarks.cli import main as port_main
from gmres_tpu_torch.ops.dd import dd_from_f64
from gmres_tpu_torch.ops.stencil import stencil_5pt_dd_pallas_blocked
from gmres_tpu_torch.utils import profiling
from tests.torch_parity import seeded, to_torch


def _rows(path):
    with open(path) as f:
        return {r["name"]: r for r in map(json.loads, f)}


def test_measure_bandwidth_and_roofline():
    """tests/test_debug_profiling.py's checks, and a (hi, lo) pair chained as
    JAX chains a pytree."""
    out = profiling.stencil_roofline(64, dtype=torch.float32, reps=3, device="cpu")
    assert out["gbps"] > 0 and out["seconds"] > 0
    assert (out["device"], out["timing"], out["peak_gbps"]) == ("cpu", "host clock", None)
    out2 = profiling.measure_bandwidth(lambda x: x * 2.0, torch.ones((64, 64)),
                                       bytes_moved=2 * 64 * 64 * 8, reps=3)
    assert out2["gbps"] > 0
    pair = dd_from_f64(to_torch(seeded(30, (64, 64))))
    out3 = profiling.measure_bandwidth(lambda p: stencil_5pt_dd_pallas_blocked(*p),
                                       pair, bytes_moved=2 * 64 * 64 * 8, reps=3)
    assert out3["gbps"] > 0 and out3["fraction_of_peak"] is None


def test_peak_by_card_name(monkeypatch):
    """The HBM peak is keyed by the card's name; any other card, and the
    CPU, give None."""
    assert profiling._device_peak_gbps("cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert profiling._device_peak_gbps(torch.device("cuda", 0)) == 3350.0
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    assert profiling._device_peak_gbps(torch.device("cuda", 0)) is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8) + 1
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_roofline_program_matches_jax(tmp_path, capsys):
    """The subcommand at tests/test_benchmarks_cli.py's size: the plain and
    V-cycle rows, JAX's fields and traffic, and the device named."""
    port_jsonl, jax_jsonl = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    port_main(["roofline", "--grids", "32", "--reps", "2", "--device", "cpu",
               "--jsonl", port_jsonl])
    printed = capsys.readouterr().out
    for row in ("stencil-plain-f32-32", "stencil-plain-f64-32", "mg-vcycle-f32-32"):
        assert printed.count(row) == 2  # the table and the throughput lines
    jax_main(["roofline", "--grids", "32", "--reps", "2", "--jsonl", jax_jsonl])
    port, ref = _rows(port_jsonl), _rows(jax_jsonl)
    names = {"stencil-plain-f32-32": "stencil-jnp-f32-32",
             "stencil-plain-f64-32": "stencil-jnp-f64-32",
             "mg-vcycle-f32-32": "mg-vcycle-f32-32"}
    assert set(port) == set(names)
    for name, jax_name in names.items():
        p, j = port[name], ref[jax_name]
        assert set(p) == set(j) | {"device", "timing"}
        for key in ("nvars", "iterations", "nnz", "matvecs", "peak_gbps",
                    "fine_equiv_sweeps"):
            assert p.get(key) == j.get(key), (name, key)
        assert p["device"] == "cpu" and p["wall_s"] > 0
        # the same traffic: equal bytes over the measured seconds
        np.testing.assert_allclose(p["gbps"] * p["wall_s"], j["gbps"] * j["wall_s"],
                                   rtol=1e-12)


def test_roofline_program_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_main(["roofline", "--grids", "32", "--reps", "2"])
