#!/usr/bin/env python3
"""Krylov–Schur on a far-from-normal operator, in both packages, from one
start vector, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/ks_nonnormal.py [N] [GAMMA_X GAMMA_Y]

The convection-diffusion operator is D T D⁻¹ with T symmetric and D =
diag((cw/ce)^(i/2)·(cs/cn)^(j/2)), so κ(D) = |cw/ce|^((N−1)/2)·|cs/cn|^((N−1)/2).
Runs gmres_tpu.arnoldi_eigs and gmres_tpu_torch.arnoldi_eigs (nev 4, steps
40, "LM", tol 1e-8, at most 200 cycles: the eig program's settings) from
JAX's PRNGKey(0) normal start, and prints for each its cycles, residuals,
eigenvalues and their moduli beside the closed form's spectral radius and
κ(D). Where log10 κ(D) is far above 16, a converged Ritz value can lie on
the pseudospectrum, outside the spectrum, and the two packages' rounding
leads them to different ones. Defaults: N = 128, γ = (2, 0.5).
"""

from __future__ import annotations

import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import gmres_tpu as gt  # noqa: E402
import gmres_tpu_torch as tt  # noqa: E402
from gmres_tpu_torch.models.convection_diffusion import (  # noqa: E402
    convection_diffusion_coefs,
    convection_diffusion_eigenvalues,
)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    g = (float(sys.argv[2]), float(sys.argv[3])) if len(sys.argv) > 3 else (2.0, 0.5)
    _, cw, ce, cs, cn = convection_diffusion_coefs(*g)
    log_kappa = (n - 1) / 2 * (math.log10(abs(cw / ce)) + math.log10(abs(cs / cn)))
    radius = float(np.max(np.abs(convection_diffusion_eigenvalues(n, *g))))
    probe = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n, n), jnp.float64))
    kw = dict(nev=4, steps=40, which="LM", tol=1e-8, max_restarts=200)
    runs = {
        "gmres_tpu": lambda: gt.arnoldi_eigs(gt.convection_diffusion_operator(n, *g),
                                             jnp.asarray(probe), **kw),
        "gmres_tpu_torch": lambda: tt.arnoldi_eigs(tt.convection_diffusion_operator(n, *g),
                                                   torch.tensor(probe), **kw),
    }
    for name, run in runs.items():
        res = run()
        lam = np.asarray(res.eigenvalues.cpu() if isinstance(res.eigenvalues, torch.Tensor)
                         else res.eigenvalues)
        resid = np.asarray(res.residuals.cpu() if isinstance(res.residuals, torch.Tensor)
                           else res.residuals)
        print(json.dumps({
            "package": name, "n": n, "gamma": g, "log10_kappa_D": log_kappa,
            "spectral_radius": radius, "cycles": int(res.iterations),
            "max_residual": float(resid.max()),
            "eigenvalues": [[float(v.real), float(v.imag)] for v in lam],
            "moduli": [float(abs(v)) for v in lam]}), flush=True)


if __name__ == "__main__":
    main()
