"""Small ops of the PyTorch port against gmres_tpu: compact-WY reflectors,
Givens updates, the masked back-substitution, flat-index and BLAS ops,
the result types — and the port's import boundary (no JAX)."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gmres_tpu
from gmres_tpu.ops import blas as jblas
from gmres_tpu.ops import flat as jflat
from gmres_tpu.ops import givens as jgiv
from gmres_tpu.ops import householder as jwy
from gmres_tpu.ops import tri as jtri
from gmres_tpu.solvers import gmres as jgm
import gmres_tpu_torch
from gmres_tpu_torch.ops import blas as tblas
from gmres_tpu_torch.ops import flat as tflat
from gmres_tpu_torch.ops import givens as tgiv
from gmres_tpu_torch.ops import householder as twy
from gmres_tpu_torch.ops import tri as ttri
from gmres_tpu_torch.solvers import gmres as tgm
from tests.torch_parity import rel_err, seeded, to_np, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float64 matmuls summed in another order than XLA's: a few ulp.
TOL64 = 1e-13


def _reflectors(seed, m, shape):
    """m+1 unit reflectors with the zero-prefix structure of Householder
    GMRES (reflector k is zero at flat indices < k)."""
    n = int(np.prod(shape))
    rows = []
    for k in range(m + 1):
        v = seeded(seed + k, n)
        v[:k] = 0.0
        rows.append((v / np.linalg.norm(v)).reshape(shape))
    return rows


def _build_wy(seed, m, shape, k):
    """(P, T) after appending reflectors 0..k-1, in both packages."""
    refl = _reflectors(seed, m, shape)
    pj = jnp.zeros((m + 1,) + shape)
    tj = jnp.zeros((m + 1, m + 1))
    pt = torch.zeros((m + 1,) + shape, dtype=torch.float64)
    ttm = torch.zeros((m + 1, m + 1), dtype=torch.float64)
    for i in range(k):
        pj, tj = jwy.wy_append(pj, tj, jnp.asarray(refl[i]), i)
        pt, ttm = twy.wy_append(pt, ttm, to_torch(refl[i]), i)
    return (pj, tj), (pt, ttm)


@pytest.mark.parametrize("k", [1, 4, 7])
def test_wy_ops_match(k):
    m, shape = 6, (5, 4)
    (pj, tj), (pt, ttm) = _build_wy(100, m, shape, k)
    assert rel_err(pt, pj) < TOL64 and rel_err(ttm, tj) < TOL64
    # zero rows beyond k stay zero after the in-place appends
    assert not pt[k:].any() and not ttm[k:].any()
    v = seeded(7, shape)
    assert rel_err(twy.wy_apply(pt, ttm, to_torch(v)),
                   jwy.wy_apply(pj, tj, jnp.asarray(v))) < TOL64
    assert rel_err(twy.wy_apply_transpose(pt, ttm, to_torch(v)),
                   jwy.wy_apply_transpose(pj, tj, jnp.asarray(v))) < TOL64
    for idx in (0, 3, m):
        assert rel_err(twy.wy_basis_vector(pt, ttm, idx),
                       jwy.wy_basis_vector(pj, tj, idx)) < TOL64
    assert rel_err(twy.wy_basis(pt, ttm, m), jwy.wy_basis(pj, tj, m)) < TOL64


def test_givens_sequence_matches():
    m = 6
    g0 = np.zeros(m + 1)
    g0[0] = 2.5
    sj = jgiv.givens_init(m, jnp.asarray(g0), 3.0)
    st = tgiv.givens_init(m, to_torch(g0), 3.0)
    for t in range(m):
        hcol = seeded(200 + t, m + 1)
        hcol[t + 2:] = 0.0
        if t == 2:
            hcol[:] = 0.0  # ds == 0: the identity rotation
        sj, cj, rj = jgiv.givens_step(sj, jnp.asarray(hcol), t)
        st, ct, rt = tgiv.givens_step(st, to_torch(hcol), t)
        for a, b in zip(st, sj):
            assert rel_err(a, b) < TOL64
        assert rel_err(ct, cj) < TOL64 and rel_err(rt, rj) < TOL64


@pytest.mark.parametrize("k", [0, 3, 8])
def test_masked_back_substitution_matches(k):
    m = 8
    h = np.triu(seeded(300, (m + 1, m))) + 4.0 * np.eye(m + 1, m)
    g = seeded(301, m + 1)
    yt = ttri.masked_back_substitution(to_torch(h), to_torch(g), k)
    yj = jtri.masked_back_substitution(jnp.asarray(h), jnp.asarray(g), k)
    assert rel_err(yt, yj) < TOL64
    assert not yt[k:].any()


@pytest.mark.parametrize("i", [0, 5, 11])
def test_flat_ops_match(i):
    x = seeded(400, (3, 4))
    xt, xj = to_torch(x), jnp.asarray(x)
    np.testing.assert_array_equal(to_np(tflat.flat_iota(xt)),
                                  to_np(jflat.flat_iota(xj)))
    assert float(tflat.flat_get(xt, i)) == float(jflat.flat_get(xj, i))
    for tf, jf in ((tflat.flat_set, jflat.flat_set),
                   (tflat.flat_add, jflat.flat_add)):
        np.testing.assert_array_equal(to_np(tf(xt, i, 2.5)), to_np(jf(xj, i, 2.5)))
    for tf, jf in ((tflat.mask_lt, jflat.mask_lt), (tflat.mask_ge, jflat.mask_ge)):
        np.testing.assert_array_equal(to_np(tf(xt, i)), to_np(jf(xj, i)))
    np.testing.assert_array_equal(
        to_np(tflat.basis_vector(i, (3, 4), torch.float64)),
        to_np(jflat.basis_vector(i, (3, 4), jnp.float64)))
    # inputs are not modified
    np.testing.assert_array_equal(to_np(xt), x)


def test_blas_ops_match():
    rows, v = seeded(500, (4, 6, 5)), seeded(501, (6, 5))
    coefs, coefs2 = seeded(502, 4), seeded(503, (4, 3))
    assert rel_err(tblas.row_contract(to_torch(rows), to_torch(v)),
                   jblas.row_contract(jnp.asarray(rows), jnp.asarray(v))) < TOL64
    assert rel_err(tblas.row_combine(to_torch(coefs), to_torch(rows)),
                   jblas.row_combine(jnp.asarray(coefs), jnp.asarray(rows))) < TOL64
    out = tblas.row_combine(to_torch(coefs2), to_torch(rows))
    assert out.shape == (3, 6, 5)
    assert rel_err(out, jblas.row_combine(jnp.asarray(coefs2), jnp.asarray(rows))) < TOL64
    assert rel_err(tblas.tree_vdot(to_torch(v), to_torch(v * 2)),
                   jblas.tree_vdot(jnp.asarray(v), jnp.asarray(v * 2))) < TOL64
    assert rel_err(tblas.tree_norm(to_torch(v)),
                   jblas.tree_norm(jnp.asarray(v))) < TOL64
    zc = seeded(504, 5) + 1j * seeded(505, 5)
    assert rel_err(tblas.tree_vdot(to_torch(zc), to_torch(zc[::-1].copy())),
                   jblas.tree_vdot(jnp.asarray(zc), jnp.asarray(zc[::-1]))) < TOL64


def test_cg_blas_ops_match():
    """The tree ops CG needs, real and complex: batched_vdot stacks the k
    inner products (conjugating the first operand) into one (k,) tensor."""
    a, b, c = seeded(506, (6, 5)), seeded(507, (6, 5)), seeded(508, (6, 5))
    ta, tb, tc = to_torch(a), to_torch(b), to_torch(c)
    ja, jb, jc = jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)
    assert rel_err(tblas.tree_sub(ta, tb), jblas.tree_sub(ja, jb)) == 0.0
    assert rel_err(tblas.tree_axpy(torch.tensor(0.3, dtype=torch.float64), ta, tb),
                   jblas.tree_axpy(jnp.asarray(0.3), ja, jb)) == 0.0
    z = tblas.tree_zeros_like(ta)
    assert z.shape == ta.shape and z.dtype == ta.dtype and not z.any()
    out = tblas.batched_vdot([(ta, tb), (tb, tc), (ta, ta)])
    assert out.shape == (3,)
    assert rel_err(out, jblas.batched_vdot([(ja, jb), (jb, jc), (ja, ja)])) < TOL64
    zc, zd = seeded(509, 5) + 1j * seeded(510, 5), seeded(511, 5) - 1j * seeded(512, 5)
    assert rel_err(tblas.batched_vdot([(to_torch(zc), to_torch(zd))]),
                   jblas.batched_vdot([(jnp.asarray(zc), jnp.asarray(zd))])) < TOL64


def test_fortran_sign_matches_including_signed_zero():
    a = np.array([1.5, -2.0, 3.0, -4.0, 0.5])
    b = np.array([2.0, -1.0, 0.0, -0.0, -3.0])
    np.testing.assert_array_equal(
        to_np(tgm._fortran_sign(to_torch(a), to_torch(b))),
        to_np(jgm._fortran_sign(jnp.asarray(a), jnp.asarray(b))))
    assert float(tgm._fortran_sign(torch.tensor(2.0), torch.tensor(-0.0))) == 2.0


def test_v_err_householder_matches():
    gram = seeded(600, (6, 6))
    for n_out in (0, 3, 6):
        assert rel_err(tgm._v_err_householder(to_torch(gram), n_out, torch.float64),
                       jgm._v_err_householder(jnp.asarray(gram), n_out, jnp.float64)) < TOL64


def test_types_mirror_jax():
    assert {s.name: int(s) for s in gmres_tpu_torch.SolverStatus} == \
        {s.name: int(s) for s in gmres_tpu.SolverStatus}
    jax_fields = [f.name for f in
                  gmres_tpu.GmresResult.__dataclass_fields__.values()]
    port_fields = list(gmres_tpu_torch.GmresResult.__dataclass_fields__)
    assert port_fields[:len(jax_fields)] == jax_fields
    jax_fields = list(gmres_tpu.SolveResult.__dataclass_fields__)
    port_fields = list(gmres_tpu_torch.SolveResult.__dataclass_fields__)
    assert port_fields[:len(jax_fields)] == jax_fields
    t = gmres_tpu_torch.as_tensor(np.arange(3.0), "cpu", torch.float32)
    assert t.dtype == torch.float32 and t.device.type == "cpu"


def test_import_leaves_jax_out():
    """Importing the port (in a fresh interpreter) loads neither jax nor
    gmres_tpu."""
    code = ("import sys, gmres_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'gmres_tpu' or m.startswith('gmres_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_import_anywhere_in_port():
    """No module of the port, and not chip_smoke.py, imports jax or
    gmres_tpu — also not lazily inside a function."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "gmres_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for p in paths:
        for mod in _imported_modules(p):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "gmres_tpu"), (p, mod)


def test_chip_smoke_fails_without_cuda():
    """Without a CUDA device the smoke run exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
