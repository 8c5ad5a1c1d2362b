"""The port's reference programs (``python -m gmres_tpu_torch.benchmarks``)
against ``benchmarks/cli.py``, on the CPU.

Each program runs with ``--device cpu`` at the smoke sizes of
tests/test_benchmarks_cli.py and the JAX program with the same arguments;
the port must print the reference table and write JSONL rows whose names
are JAX's and whose iterations, restarts and status are JAX's within 2.
In one process the scaling programs make a one-rank gloo group, so they run
at d = 1 only (and JAX is given ``--max-devices 1``); two gloo processes
(tests/torch_halo_worker.py) run ``strong-scaling --explicit-halo`` and
``weak-scaling --precond chebyshev`` at d = 1, 2 against JAX's two-device
rows, and ``weak-scaling --precond mg`` (the distributed V-cycle at d = 2)
against JAX's rows at 32 rows a device. Times are host times and are not
compared.
"""

import json
import os
import subprocess
import sys

import pytest
import torch.multiprocessing as mp

from benchmarks.cli import main as jax_main
from gmres_tpu_torch.benchmarks.cli import main as port_main
from tests import torch_halo_worker

RUNS = {
    "dense-poisson": ["dense-poisson", "--nsize", "8", "--restart", "20",
                      "--tol", "1e-12"],
    "hilbert": ["hilbert", "--n", "8", "--restart", "8", "--tol", "1e-14"],
    "poisson-mf": ["poisson-mf", "--nsize", "24", "--restart", "20",
                   "--tol", "1e-10", "--no-v-err"],
    "poisson-mf-mixed": ["poisson-mf", "--nsize", "24", "--restart", "20",
                         "--tol", "1e-9", "--no-v-err", "--mixed"],
    "cg": ["cg", "--grids", "16:24:8", "--tol", "1e-8"],
    "bicgstab": ["bicgstab", "--grids", "16:16:8", "--tol", "1e-8"],
    "strong-scaling": ["strong-scaling", "--nsize", "16", "--restart", "10",
                       "--tol", "1e-8", "--max-devices", "1",
                       "--max-restarts", "200"],
    "strong-scaling-halo": ["strong-scaling", "--nsize", "16", "--restart",
                            "10", "--tol", "1e-8", "--max-devices", "1",
                            "--explicit-halo", "--max-restarts", "200"],
    "weak-scaling": ["weak-scaling", "--nsize-per-device", "8", "--restart",
                     "10", "--tol", "1e-8", "--max-devices", "1",
                     "--max-restarts", "200"],
    "weak-scaling-chebyshev": ["weak-scaling", "--nsize-per-device", "8",
                               "--restart", "10", "--tol", "1e-8",
                               "--max-devices", "1", "--max-restarts", "200",
                               "--precond", "chebyshev"],
    "restart-sweep": ["restart-sweep", "--nsize", "16", "--start", "5",
                      "--step", "5", "--ntests", "2", "--tol", "1e-8"],
    "restart-sweep-cycles": ["restart-sweep", "--nsize", "16", "--start", "5",
                             "--step", "5", "--ntests", "2", "--tol", "1e-8",
                             "--cycle-reps", "2", "--repeats", "2"],
    # convdiff at 32² with each solver and preconditioner it offers (16²
    # unpreconditioned); the auto smoother's Arnoldi probe is the port's own.
    # (At γ = (2, 1) the counts move with the reductions' order by more than
    # 2: tests/test_torch_nonsym.py holds them to a band.)
    "convdiff-plain": ["convdiff", "--nsize", "16"],
    "convdiff-mg": ["convdiff", "--nsize", "32", "--precond", "mg"],
    "convdiff-mg-mixed-auto": ["convdiff", "--nsize", "32", "--precond", "mg",
                               "--precision", "mixed", "--smoother", "auto"],
    "convdiff-mg-rbgs": ["convdiff", "--nsize", "32", "--precond", "mg",
                         "--smoother", "rbgs"],
    "convdiff-gmres-mixed-auto": ["convdiff", "--nsize", "32", "--precond", "mg",
                                  "--solver", "gmres", "--precision", "mixed",
                                  "--smoother", "auto"],
    "convdiff-bicgstabl": ["convdiff", "--nsize", "32", "--precond", "mg",
                           "--solver", "bicgstabl"],
    "convdiff-cgs": ["convdiff", "--nsize", "32", "--precond", "mg", "--solver", "cgs"],
    "convdiff-tfqmr": ["convdiff", "--nsize", "32", "--precond", "mg",
                       "--solver", "tfqmr"],
    "convdiff-poly": ["convdiff", "--nsize", "32", "--precond", "poly"],
    "convdiff-idrs": ["convdiff", "--nsize", "32", "--precond", "mg", "--solver", "idrs"],
    "restart-sweep-lgmres": ["restart-sweep", "--nsize", "16", "--start", "5", "--step",
                             "5", "--ntests", "2", "--tol", "1e-8", "--solver", "lgmres"],
    "restart-sweep-gmres-dr": ["restart-sweep", "--nsize", "16", "--start", "5", "--step",
                               "5", "--ntests", "2", "--tol", "1e-8", "--solver",
                               "gmres-dr", "--deflate", "2"],
    "multirhs-block-gmres": ["multirhs", "--nsize", "16", "--s-list", "1,3", "--solver",
                             "block-gmres", "--restart", "10"],
    # JAX's default solver, block CG.
    "multirhs-block-cg": ["multirhs", "--nsize", "16", "--s-list", "1,3"],
    "varcoef": ["varcoef", "--nsize", "24"],
    # Helmholtz: MINRES with the SPD cycle (23 against 24 steps: M's last
    # bits, tests/test_torch_helmholtz.py), the complex CSL route and the
    # split route's GCRO-DR; Bratu with the FGMRES and GCRO-DR inner
    # solvers; QMR with the derived transpose (16²: unpreconditioned QMR
    # stalls above the absolute 1e-9 from 64² on, in gmres_tpu too).
    "helmholtz-mg": ["helmholtz", "--nsize", "32"],
    "helmholtz-csl": ["helmholtz", "--nsize", "32", "--precond", "csl"],
    "helmholtz-split-gcrodr": ["helmholtz", "--nsize", "32", "--precond", "csl",
                               "--precision", "split", "--solver", "gcrodr", "--restart",
                               "40", "--deflate", "5"],
    "bratu": ["bratu", "--nsize", "32"],
    "bratu-gcrodr": ["bratu", "--nsize", "32", "--inner", "gcrodr", "--precond", "none"],
    "convdiff-qmr": ["convdiff", "--nsize", "16", "--solver", "qmr"],
}
# Two gloo ranks, and JAX's rows on two devices.
RUNS_2 = {
    "strong-scaling-halo": ["strong-scaling", "--nsize", "16", "--restart",
                            "10", "--tol", "1e-8", "--max-devices", "2",
                            "--explicit-halo", "--max-restarts", "200"],
    "weak-scaling-chebyshev": ["weak-scaling", "--nsize-per-device", "8",
                               "--restart", "10", "--tol", "1e-8",
                               "--max-devices", "2", "--max-restarts", "200",
                               "--precond", "chebyshev"],
}
RUN_2_MG = ["weak-scaling", "--nsize-per-device", "32", "--restart", "10",
            "--tol", "1e-8", "--max-devices", "2", "--max-restarts", "200"]
HEADER = "solver"


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _check_rows(port, ref):
    """The port's rows are JAX's by name, with iterations and restarts
    within 2 and the same status."""
    ref = {r["name"]: r for r in ref}
    assert port and {r["name"] for r in port} <= set(ref)
    for p in port:
        j = ref[p["name"]]
        # XLA's HLO has no PyTorch counterpart: the key is left out.
        assert "hlo_static_collectives" not in p
        for key in ("iterations", "restarts"):
            if key in j:
                assert abs(p[key] - j[key]) <= 2, (p["name"], key, p[key], j[key])
        assert p["nvars"] == j["nvars"]
        # JAX's rows carry no status: every smoke solve of JAX's converges
        # (its residual under tol), and so must the port's (status 0).
        assert j["residual"] < j["tol"] and p["status"] == 0, (p, j)


@pytest.mark.parametrize("label", sorted(RUNS))
def test_program_matches_jax(label, tmp_path, capsys):
    argv = RUNS[label]
    port_jsonl, jax_jsonl = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    port_main(argv + ["--device", "cpu", "--jsonl", port_jsonl])
    printed = capsys.readouterr().out
    assert HEADER in printed and "time[s]" in printed
    jax_main(argv + ["--jsonl", jax_jsonl])
    port, ref = _rows(port_jsonl), _rows(jax_jsonl)
    _check_rows(port, ref)
    names = [r["name"] for r in port]
    for r in port:
        assert names.count(r["name"]) == 1 and r["name"] in printed


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("cli_world2")
    runs = {k: v + ["--device", "cpu"] for k, v in RUNS_2.items()}
    runs["weak-scaling-mg"] = RUN_2_MG + ["--device", "cpu"]
    mp.spawn(torch_halo_worker.run_cli,
             args=(2, os.path.join(out_dir, "rendezvous"), str(out_dir), runs),
             nprocs=2)
    return out_dir


@pytest.mark.parametrize("label", sorted(RUNS_2))
def test_two_rank_program_matches_jax(label, two_ranks, tmp_path):
    """Rows at d = 1 and d = 2 from two gloo ranks, against JAX's."""
    for rank in (0, 1):
        assert not os.path.exists(os.path.join(two_ranks, f"{label}.rank{rank}.err"))
    port = _rows(os.path.join(two_ranks, f"{label}.jsonl"))
    assert [r["devices"] for r in port] == [1, 2]
    jax_jsonl = str(tmp_path / "jax.jsonl")
    jax_main(RUNS_2[label] + ["--jsonl", jax_jsonl])
    _check_rows(port, _rows(jax_jsonl))


def test_weak_scaling_mg_on_two_ranks_raises(two_ranks, tmp_path):
    """d = 2 needs the distributed V-cycle, which the port refused until the
    distributed slice; now the rows at d = 1 (the plain cycle) and d = 2
    (the mesh= cycle on a row-sharded b) take the iterations and restarts
    of JAX's program on two devices, exactly."""
    for rank in (0, 1):
        assert not os.path.exists(os.path.join(two_ranks, f"weak-scaling-mg.rank{rank}.err"))
    port = _rows(os.path.join(two_ranks, "weak-scaling-mg.jsonl"))
    assert [r["devices"] for r in port] == [1, 2]
    jax_jsonl = str(tmp_path / "jax.jsonl")
    jax_main(RUN_2_MG + ["--jsonl", jax_jsonl])
    ref = {r["name"]: r for r in _rows(jax_jsonl)}
    _check_rows(port, list(ref.values()))
    for p in port:
        assert (p["iterations"], p["restarts"]) == (ref[p["name"]]["iterations"],
                                                    ref[p["name"]]["restarts"])


@pytest.mark.parametrize("solver,precond", [("qmr", "mg")])
def test_unported_convdiff_solver_exits(solver, precond, capsys):
    """qmr with the multigrid cycle exits with gmres_tpu's message (the
    cycle has no transpose rule); qmr itself is ported (RUNS)."""
    argv = ["convdiff", "--nsize", "16", "--solver", solver, "--precond", precond]
    with pytest.raises(SystemExit) as exc:
        port_main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as jax_exc:
        jax_main(argv)
    assert str(exc.value.code) == str(jax_exc.value.code)
    assert "no transpose rule" in str(exc.value.code)
    assert "solver" not in capsys.readouterr().out  # no table: nothing ran


def test_helmholtz_solver_label_fault_is_pinned(tmp_path):
    """gmres_tpu's helmholtz program runs MINRES for --solver gcrodr with
    the SPD cycle and names the row gcrodr (ROADMAP queue 3); the port's
    takes choices and exits on a solver it would not run."""
    argv = ["helmholtz", "--nsize", "16", "--solver", "gcrodr"]
    jax_jsonl = str(tmp_path / "jax.jsonl")
    jax_main(argv + ["--jsonl", jax_jsonl])
    (row,) = _rows(jax_jsonl)
    minres = str(tmp_path / "minres.jsonl")
    jax_main(["helmholtz", "--nsize", "16", "--jsonl", minres])
    assert row["name"] == "gcrodr-helmholtz-16x16"
    assert row["iterations"] == _rows(minres)[0]["iterations"]  # MINRES's count
    with pytest.raises(SystemExit) as exc:
        port_main(argv + ["--device", "cpu"])
    assert "CSL route only" in str(exc.value.code)
    with pytest.raises(SystemExit):
        port_main(["helmholtz", "--solver", "bicg", "--device", "cpu"])


def test_helmholtz_gcrodr_count_mirrors_jax(tmp_path, monkeypatch):
    """The gcrodr arm's total_inner is gmres_tpu's (restarts − 1)·restart +
    iterations (mirrored, so that rows compare; ROADMAP queue 3), which
    overstates the steps GCRO-DR ran: a recycled cycle runs restart − k."""
    from gmres_tpu_torch.solvers import gcrodr as gcrodr_module

    argv = RUNS["helmholtz-split-gcrodr"]
    applications = []
    inner = gcrodr_module.gcrodr

    def counted(A, b, **kw):
        calls = [0]

        def op(v):
            calls[0] += 1
            return A(v)

        res = inner(op, b, **kw)
        applications.append(calls[0])
        return res

    monkeypatch.setattr(gcrodr_module, "gcrodr", counted)
    port_jsonl, jax_jsonl = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    port_main(argv + ["--device", "cpu", "--jsonl", port_jsonl])
    jax_main(argv + ["--jsonl", jax_jsonl])
    (p,), (j,) = _rows(port_jsonl), _rows(jax_jsonl)
    restart = 40
    assert p["total_inner"] == (p["restarts"] - 1) * restart + p["iterations"]
    assert abs(p["total_inner"] - j["total_inner"]) <= 2
    # The timed solve's operator applications are the k-row import (of the
    # zero block) and one a step: the steps are fewer than total_inner.
    k = 5
    assert p["restarts"] >= 3 and applications[-1] - k < p["total_inner"]


def test_sequence_program_matches_jax(tmp_path):
    """GCRO-DR fresh and warm over two frequencies: the rows in order, by
    name and frequency; the fresh rows' counts JAX's, the warm rows' cycles
    within 15% (the host eigensolves split close harmonic Ritz values
    otherwise than JAX: 132 cycles against 141 at a third, 11·λ_min)."""
    argv = ["sequence", "--nsize", "24", "--k", "4", "--restart", "16", "--kh2-factors",
            "10.0,10.5"]
    port_jsonl, jax_jsonl = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    port_main(argv + ["--device", "cpu", "--jsonl", port_jsonl])
    jax_main(argv + ["--jsonl", jax_jsonl])
    port, ref = _rows(port_jsonl), _rows(jax_jsonl)
    assert [(r["name"], r["kh2_factor"]) for r in port] == \
        [(r["name"], r["kh2_factor"]) for r in ref]
    for p, j in zip(port, ref):
        assert p["status"] == (0 if j["residual"] < j["tol"] else 1)
        assert abs(p["restarts"] - j["restarts"]) <= max(2, 0.15 * j["restarts"]), (p, j)
        if p["name"].startswith("gcrodr-fresh"):
            assert (p["restarts"], p["iterations"]) == (j["restarts"], j["iterations"])


# The spectral and time-stepping programs at 24² (evolve at 5 steps). The
# eig program's start (the Krylov–Schur probe, the LOBPCG block), subspace
# iteration's start block and the slq probes are JAX's draws, patched into
# the port's seams.
SPECTRAL_RUNS = {
    "eig-lobpcg": ["eig", "--nsize", "24"],
    "eig-arnoldi": ["eig", "--nsize", "24", "--method", "arnoldi"],
    "eig-ks-real": ["eig", "--nsize", "24", "--method", "ks_real"],
    "eig-subspace": ["eig", "--nsize", "24", "--method", "subspace", "--max-iterations",
                     "100", "--tol", "0.1"],
    "slq": ["slq", "--nsize", "24", "--probes-list", "4,8", "--steps", "20"],
    "evolve": ["evolve", "--nsize", "24", "--steps", "5"],
    "evolve-mg": ["evolve", "--nsize", "24", "--steps", "5", "--precond", "mg"],
    "evolve-heat-cg": ["evolve", "--nsize", "24", "--steps", "5", "--model", "heat",
                       "--solver", "cg"],
    "evolve-expm": ["evolve", "--nsize", "24", "--steps", "5", "--model", "heat",
                    "--solver", "expm"],
}


def _patch_jax_draws(monkeypatch):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from gmres_tpu_torch.benchmarks import cli as port_cli
    from gmres_tpu_torch.solvers import funm as port_funm
    from gmres_tpu_torch.solvers import subspace_eigs as port_subspace

    def normal(shape, dtype, dev):
        a = np.asarray(jax.random.normal(jax.random.PRNGKey(0), tuple(shape),
                                         dtype=jnp.dtype(str(dtype).replace("torch.", ""))))
        return torch.as_tensor(a.copy()).to(dev)

    def rademacher(n_probes, shape, dtype, device, key):
        a = np.asarray(jax.random.rademacher(jax.random.PRNGKey(key), (n_probes,) + tuple(shape),
                                             dtype=jnp.float64))
        return torch.as_tensor(a.copy()).to(device, dtype)

    def start_block(n, p, dtype, device):
        a = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (n, p), jnp.float64))
        return torch.as_tensor(a.copy()).to(device, dtype)

    monkeypatch.setattr(port_cli, "_program_normal", normal)
    monkeypatch.setattr(port_funm, "_rademacher", rademacher)
    monkeypatch.setattr(port_subspace, "_start_block", start_block)


@pytest.mark.parametrize("label", sorted(SPECTRAL_RUNS))
def test_spectral_program_matches_jax(label, tmp_path, monkeypatch):
    """The eig, slq and evolve rows against JAX's: the same names, the
    iterations (restart cycles, LOBPCG iterations, inner iterations over the
    trajectory) within 2, the same convergence; eigenvalues within 1e-8
    relative of JAX's (the convection-diffusion spectrum is ill-conditioned:
    a 1e-8 residual), the log-det within 1e-10 relative, and the
    trajectory's worst residual under tol in both."""
    import numpy as np

    _patch_jax_draws(monkeypatch)
    argv = SPECTRAL_RUNS[label]
    port_jsonl, jax_jsonl = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    port_main(argv + ["--device", "cpu", "--jsonl", port_jsonl])
    jax_main(argv + ["--jsonl", jax_jsonl])
    port, ref = _rows(port_jsonl), _rows(jax_jsonl)
    assert [r["name"] for r in port] == [r["name"] for r in ref]
    for p, j in zip(port, ref):
        assert abs(p["iterations"] - j["iterations"]) <= 2, (p["name"], p["iterations"],
                                                              j["iterations"])
        assert p["nvars"] == j["nvars"]
        if "converged" in j:
            assert p["converged"] == j["converged"]
        if "eigenvalues" in j:
            pe = np.array(p["eigenvalues"], dtype=float)
            je = np.array(j["eigenvalues"], dtype=float)
            assert np.max(np.abs(np.sort(pe, axis=0) - np.sort(je, axis=0))) \
                < 1e-8 * np.max(np.abs(je)), p["name"]
            assert abs(p["linf_error"] - j["linf_error"]) < 1e-8 * np.max(np.abs(je))
        if "value" in j:
            assert abs(p["value"] - j["value"]) < 1e-10 * abs(j["value"])
            assert abs(p["stderr"] - j["stderr"]) < 1e-10 * abs(j["value"])
        if p["name"].startswith("evolve") and "expm" not in p["name"]:
            assert p["residual"] < p["tol"] and j["residual"] < j["tol"]
            assert p["status"] == 0
        for key in ("iters_step0", "iters_last"):
            if key in j:
                assert abs(p[key] - j[key]) <= 2, (key, p[key], j[key])


def test_evolve_heat_mg_fault_is_pinned(capsys):
    """gmres_tpu's evolve program builds the heat model's M from the
    Helmholtz SPD cycle with kh2 = −σ (benchmarks/cli.py:1040-1042), so a
    level's shifted λmax 8 − σ·4ˡ reaches 0 and the setup divides by zero;
    the port keeps the program as it is and fails the same way."""
    argv = ["evolve", "--nsize", "24", "--steps", "3", "--model", "heat", "--precond", "mg"]
    with pytest.raises(ZeroDivisionError):
        jax_main(argv)
    with pytest.raises(ZeroDivisionError):
        port_main(argv + ["--device", "cpu"])
    assert "evolve-heat" not in capsys.readouterr().out


# tests/test_benchmarks_cli.py:72-75: the scale program's two arms and spmv.
SCALE_SPMV_RUNS = {
    "scale": ["scale", "--grids", "16,32", "--restart", "8", "--tol", "1e-8"],
    "scale-3d": ["scale", "--grids", "16,32", "--tol", "1e-8", "--dim", "3"],
    "spmv": ["spmv", "--nsize", "32", "--reps", "2"],
}


@pytest.mark.parametrize("label", sorted(SCALE_SPMV_RUNS))
def test_scale_and_spmv_match_jax(label, tmp_path, capsys):
    """The scale and spmv programs with --device cpu against gmres_tpu's: the
    same rows in the same order, each with JAX's nvars, nnz, iterations,
    restarts and total_iters, and (scale) status 0 where JAX's residual is
    under its tol. Times are not compared. On the CPU spmv has no kernel
    rows, as JAX's has none off the TPU."""
    argv = SCALE_SPMV_RUNS[label]
    port_jsonl, jax_jsonl = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    port_main(argv + ["--device", "cpu", "--jsonl", port_jsonl])
    printed = capsys.readouterr().out
    jax_main(argv + ["--jsonl", jax_jsonl])
    port, ref = _rows(port_jsonl), _rows(jax_jsonl)
    assert [r["name"] for r in port] == [r["name"] for r in ref]
    for p, j in zip(port, ref):
        assert p["name"] in printed
        for key in ("nvars", "nnz", "iterations", "restarts", "total_iters"):
            assert p.get(key) == j.get(key), (p["name"], key, p.get(key), j.get(key))
        if "residual" in j:
            assert j["residual"] < j["tol"] and p["status"] == 0 and p["residual"] < p["tol"]
        else:
            assert "status" not in p and p["gnnz_per_s"] > 0


def test_solver_choices_are_validated():
    with pytest.raises(SystemExit):
        port_main(["restart-sweep", "--solver", "gmress", "--device", "cpu"])


@pytest.mark.parametrize("program", sorted({v[0] for v in RUNS.values()}
                                            | {v[0] for v in SPECTRAL_RUNS.values()}
                                            | {"roofline", "scale", "spmv"}))
def test_program_raises_without_a_card(program, monkeypatch):
    """No CUDA device and no --device cpu: the program raises, it does not
    fall back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main([program])


def test_help_lists_the_programs():
    out = subprocess.run([sys.executable, "-m", "gmres_tpu_torch.benchmarks", "--help"],
                         capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))).stdout
    for program in ("dense-poisson", "hilbert", "poisson-mf", "cg", "bicgstab", "convdiff",
                    "strong-scaling", "weak-scaling", "restart-sweep", "multirhs",
                    "varcoef", "roofline", "bratu", "helmholtz", "sequence", "eig", "slq",
                    "evolve", "scale", "spmv"):
        assert program in out


BLOCKED = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "gmres_tpu.")) or name == "gmres_tpu":
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
sys.modules["jax"] = None
import gmres_tpu_torch
import gmres_tpu_torch.benchmarks.cli
import gmres_tpu_torch.solvers.bicgstab, gmres_tpu_torch.solvers.lanczos
import gmres_tpu_torch.models.hilbert, gmres_tpu_torch.utils.reporting
import gmres_tpu_torch.precond.chebyshev, gmres_tpu_torch.ops.stencil
import gmres_tpu_torch.models.convection_diffusion, gmres_tpu_torch.precond.multigrid
import gmres_tpu_torch.precond.polynomial, gmres_tpu_torch.solvers.cgs
import gmres_tpu_torch.solvers.tfqmr, gmres_tpu_torch.solvers.bicgstabl
import gmres_tpu_torch.solvers.sstep, gmres_tpu_torch.solvers.fgmres
import gmres_tpu_torch.solvers.lgmres, gmres_tpu_torch.solvers.block_gmres
import gmres_tpu_torch.solvers.idrs, gmres_tpu_torch.solvers.gmres_dr
import gmres_tpu_torch.solvers.gcrodr, gmres_tpu_torch.ops.hessenberg_eig
import gmres_tpu_torch.solvers.block_cg, gmres_tpu_torch.solvers.minres
import gmres_tpu_torch.solvers.sstep_cg, gmres_tpu_torch.solvers.chebyshev
import gmres_tpu_torch.models.poisson3d, gmres_tpu_torch.models.anisotropic
import gmres_tpu_torch.models.varcoef, gmres_tpu_torch.ops.tridiag
import gmres_tpu_torch.precond.deflation
import gmres_tpu_torch.models.helmholtz, gmres_tpu_torch.models.bratu
import gmres_tpu_torch.solvers.qmr, gmres_tpu_torch.solvers.lsqr
import gmres_tpu_torch.solvers.lsmr, gmres_tpu_torch.solvers.implicit
import gmres_tpu_torch.solvers.newton_krylov
import gmres_tpu_torch.solvers.arnoldi, gmres_tpu_torch.solvers.krylov_schur_real
import gmres_tpu_torch.solvers.subspace_eigs, gmres_tpu_torch.solvers.lobpcg
import gmres_tpu_torch.solvers.funm, gmres_tpu_torch.solvers.evolve
import gmres_tpu_torch.precond.nystrom, gmres_tpu_torch.precond.spai
import gmres_tpu_torch.utils.checkpoint, gmres_tpu_torch.utils.debug
gmres_tpu_torch.benchmarks.cli.main(["eig", "--nsize", "12", "--method", "arnoldi",
                                     "--steps", "20", "--device", "cpu"])
gmres_tpu_torch.benchmarks.cli.main(["eig", "--nsize", "12", "--method", "ks_real",
                                     "--steps", "20", "--device", "cpu"])
gmres_tpu_torch.benchmarks.cli.main(["slq", "--nsize", "12", "--probes-list", "2",
                                     "--steps", "10", "--device", "cpu"])
gmres_tpu_torch.benchmarks.cli.main(["helmholtz", "--nsize", "16", "--device", "cpu"])
gmres_tpu_torch.benchmarks.cli.main(["bratu", "--nsize", "16", "--device", "cpu"])
gmres_tpu_torch.benchmarks.cli.main(["convdiff", "--nsize", "16", "--solver", "qmr",
                                     "--device", "cpu"])
gmres_tpu_torch.benchmarks.cli.main(["bicgstab", "--grids", "8:8:8", "--device", "cpu"])
gmres_tpu_torch.benchmarks.cli.main(["restart-sweep", "--nsize", "12", "--ntests", "1",
                                     "--start", "5", "--tol", "1e-8", "--solver", "gmres-dr",
                                     "--deflate", "2", "--device", "cpu"])
gmres_tpu_torch.benchmarks.cli.main(["multirhs", "--nsize", "8", "--s-list", "2",
                                     "--solver", "block-gmres", "--device", "cpu"])
gmres_tpu_torch.benchmarks.cli.main(["multirhs", "--nsize", "8", "--s-list", "2",
                                     "--solver", "block-cg", "--device", "cpu"])
gmres_tpu_torch.benchmarks.cli.main(["varcoef", "--nsize", "24", "--device", "cpu"])
gmres_tpu_torch.gcrodr(gmres_tpu_torch.poisson_operator(8),
                       gmres_tpu_torch.poisson_operator(8)(__import__("torch").ones(8, 8,
                           dtype=__import__("torch").float64)), k=2, restart=6)
gmres_tpu_torch.benchmarks.cli.main(["convdiff", "--nsize", "32", "--precond", "mg",
                                     "--smoother", "auto", "--solver", "idrs", "--device",
                                     "cpu"])
assert not any(m == "jax" or m.startswith(("jax.", "gmres_tpu.")) or m == "gmres_tpu"
               for m in sys.modules if sys.modules[m] is not None)
print("no jax")
"""


def test_port_imports_no_jax():
    """The new modules import and a program runs with jax and gmres_tpu
    blocked, in a fresh process."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", BLOCKED], capture_output=True,
                         text=True, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "no jax" in out.stdout
