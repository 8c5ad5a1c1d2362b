"""Two counts of the GMRES family that differ from gmres_tpu's at the
smoke run's sizes, and the mechanisms behind them, on the CPU.

* FGMRES with four steps of CG as its preconditioner (a nonlinear M)
  amplifies last-bit differences from cycle to cycle, where a linear M does
  not, so a long run's restart count follows the reductions' rounding: the
  smoke run holds this row to a band.
* s-step GMRES with a float32 Krylov block: the port accumulates the
  block's Gram in float64, because torch's float32 GEMM sums the
  (s+1) × n × (s+1) product less accurately than XLA does, enough to make
  the equilibrated Gram indefinite past its ridge (a BREAKDOWN after one
  cycle at 512²). With the float64 sums the port converges at 512², its
  count within 15% of gmres_tpu's (the float32 sums of the block move it
  with the thread count on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from tests.torch_parity import seeded, to_torch


def test_fgmres_nonlinear_preconditioner_amplifies_last_bits():
    """FGMRES(10) at 128², 20 cycles: M's output perturbed by one ulp in a
    seeded pattern moves x by more than 1e-10 after 20 cycles when M is
    four CG steps (nonlinear: the next cycle's directions depend on the
    last bits), and by less than 1e-12 when M is the linear cbpr2. So a
    long run's restart count follows the reductions' rounding (gmres_tpu's
    XLA sums, the port's torch sums), as at 300²: gmres_tpu 111, the port
    116 on the CPU, 117 on the card."""
    n = 128
    op = tt.poisson_operator(n)
    b = op(torch.ones((n, n), dtype=torch.float64))
    bump = to_torch(1.0 + 2.0 ** -52 * np.sign(seeded(5, (n, n))))
    moved = {}
    for name, m in (("cg4", lambda r: tt.cg(op, r, tol=0.0, max_iterations=4).x),
                    ("cbpr2", tt.chebyshev_preconditioner(op, 0.2, 8.2))):
        kw = dict(restart=10, tol=0.0, max_restarts=20)
        base = tt.fgmres(op, b, M=m, **kw)
        bumped = tt.fgmres(op, b, M=lambda r, m=m: m(r) * bump, **kw)
        assert base.restarts == bumped.restarts == 20
        moved[name] = float((base.x - bumped.x).abs().max() / base.x.abs().max())
    assert moved["cg4"] > 1e-10 and moved["cbpr2"] < 1e-12, moved


def test_sstep_float32_block_sums_its_gram_in_float64():
    n = 512
    opj, opt = gt.poisson_operator(n), tt.poisson_operator(n)
    mj = gt.chebyshev_preconditioner(opj, 0.005, 8.0, order=16)
    mt = tt.chebyshev_preconditioner(opt, 0.005, 8.0, order=16)
    b = np.asarray(opj(jnp.ones((n, n))))
    rj = jax.jit(lambda bb: gt.sstep_gmres(opj, bb, s=8, tol=1e-6, M=mj,
                                           inner_dtype=jnp.float32))(jnp.asarray(b))
    rt = tt.sstep_gmres(opt, to_torch(b), s=8, tol=1e-6, M=mt, inner_dtype=torch.float32)
    assert rt.status == int(rj.status) == 0
    # The float32 block's count moves with its float32 rounding (41–45 in
    # the port on the CPU across thread counts, against gmres_tpu's 45).
    assert abs(rt.restarts - int(rj.restarts)) <= 0.15 * int(rj.restarts)
    # The float32 product itself: torch's is the less accurate one here.
    z = torch.as_tensor(seeded(6, (9, n * n)), dtype=torch.float32)
    exact = z.double() @ z.double().T
    torch_f32 = (z @ z.T).double()
    zj = jnp.asarray(z.numpy())
    xla_f32 = np.asarray((zj @ zj.T).astype(jnp.float64))
    err_torch = float((torch_f32 - exact).abs().max() / exact.abs().max())
    err_xla = float(np.abs(xla_f32 - exact.numpy()).max() / exact.abs().max())
    assert err_torch > 2 * err_xla
