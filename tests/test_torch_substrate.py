"""Substrate of the PyTorch port against the JAX package: tensor ops,
Lanczos, MPOs and models, finite MPS, transfer pushes and environments.
Inputs are made with numpy from a seed and fed to both packages, in
float64 (complex128 where the phase convention matters)."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import dmrg as jdmrg
from mpskit_tpu.environments import finite as jenv
from mpskit_tpu.linalg import lanczos as jlan
from mpskit_tpu.models import hamiltonians as jham
from mpskit_tpu.states import finitemps as jmps
from mpskit_tpu.tensors import ops as jops
from mpskit_tpu.transfermatrix import transfer as jtr
from mpskit_tpu.utils import dynamictols as jtols
from mpskit_tpu_torch.algorithms import dmrg as tdmrg
from mpskit_tpu_torch.environments import finite as tenv
from mpskit_tpu_torch.linalg import lanczos as tlan
from mpskit_tpu_torch.models import hamiltonians as tham
from mpskit_tpu_torch.states import finitemps as tmps
from mpskit_tpu_torch.tensors import ops as tops
from mpskit_tpu_torch.transfermatrix import transfer as ttr
from mpskit_tpu_torch.utils import dynamictols as ttols
from mpskit_tpu_torch.interop import finite_mps_from_numpy, mpo_from_numpy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-12, atol=1e-12)


def _rand(rng, shape, dtype=np.float64):
    a = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("shape", [(12, 5), (5, 12)])
def test_qr_lq_pos_match_jax(dtype, shape):
    M = _rand(np.random.default_rng(0), shape, dtype)
    for jf, tf in ((jops.qr_pos, tops.qr_pos), (jops.lq_pos, tops.lq_pos),
                   (jops.cholesky_qr2, tops.cholesky_qr2)):
        if jf is jops.cholesky_qr2 and shape[0] < shape[1]:
            continue  # CholeskyQR2 is for tall full-rank panels only
        for a, b in zip(tf(_t(M)), jf(jnp.asarray(M))):
            np.testing.assert_allclose(_np(a), _np(b), **TOL)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_gauge_moves_match_jax(dtype):
    """leftorth/rightorth (and their hybrid forms) on full-rank tensors,
    and on a zero-padded, rank-deficient edge tensor."""
    rng = np.random.default_rng(1)
    A = _rand(rng, (6, 2, 6), dtype)
    edge = np.zeros((6, 2, 6), dtype)
    edge[:2, :, :4] = _rand(rng, (2, 2, 4), dtype)
    for X in (A, edge):
        for jf, tf in ((jops.leftorth, tops.leftorth),
                       (jops.rightorth, tops.rightorth)):
            for a, b in zip(tf(_t(X)), jf(jnp.asarray(X))):
                np.testing.assert_allclose(_np(a), _np(b), **TOL)
    AL, C = tops.leftorth_hybrid(_t(A), True)
    jAL, jC = jops.leftorth_hybrid(jnp.asarray(A), True)
    np.testing.assert_allclose(_np(AL), _np(jAL), rtol=1e-10, atol=1e-10)
    C, AR = tops.rightorth_hybrid(_t(A), False)
    jC, jAR = jops.rightorth(jnp.asarray(A))
    np.testing.assert_allclose(_np(AR), _np(jAR), **TOL)
    # the edge panel's junk columns carry no weight: masking AL to the
    # supported block (as DMRG does) still reconstructs the tensor
    AL, C = tops.leftorth(_t(edge))
    mask = np.zeros(edge.shape, bool)
    mask[:2, :, :4] = True
    np.testing.assert_allclose(
        _np(torch.einsum("lpm,mr->lpr", AL * _t(mask), C)), edge, **TOL)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("reorth", ["local1", "local", "full"])
def test_eigsh_smallest_matches_jax_and_eigvalsh(reorth, fast):
    """The smallest eigenvalue of a random symmetric matrix from both
    packages and from numpy. fast=True runs the probe path, with the exact
    matvec as its 'inexact' one (as on the CPU)."""
    rng = np.random.default_rng(2)
    n = 48
    A = rng.standard_normal((n, n))
    A = A + A.T
    v0 = rng.standard_normal(n)
    exact = np.linalg.eigvalsh(A)[0]
    At, Aj = _t(A), jnp.asarray(A)
    res_t = tlan.eigsh_smallest(lambda x: At @ x, _t(v0), 16, 60, 1e-12,
                                reorth=reorth,
                                matvec_fast=(lambda x: At @ x) if fast else None)
    res_j = jlan.eigsh_smallest(lambda x: Aj @ x, jnp.asarray(v0), 16, 60,
                                1e-12, reorth,
                                (lambda x: Aj @ x) if fast else None)
    assert res_t.converged
    assert abs(res_t.eigenvalue - exact) <= 1e-10
    assert abs(res_t.eigenvalue - float(res_j.eigenvalue)) <= 1e-10
    x = _np(res_t.eigenvector)
    np.testing.assert_allclose(abs(x @ np.asarray(res_j.eigenvector)), 1.0,
                               atol=1e-10)


def _models(mod):
    return [mod.transverse_field_ising(g=1.2),
            mod.transverse_field_ising_lattice(g=1.5),
            mod.transverse_field_ising_lattice(g=0.7, dtype=np.float64),
            mod.heisenberg_XXX(spin=0.5), mod.heisenberg_XXX(spin=1)]


def test_mpo_models_match_jax_bit_for_bit():
    for Ht, Hj in zip(_models(tham), _models(jham)):
        Wj = np.asarray(Hj.W)
        assert Ht.W.dtype == Wj.dtype and np.array_equal(Ht.W, Wj)
        for H in (Ht, mpo_from_numpy(Wj)):
            assert H.nonzero_mask == Hj.nonzero_mask
            assert H.diag_class == Hj.diag_class
            assert H.diag_scalar == Hj.diag_scalar
        assert np.array_equal(Ht.to_matrix(4), Hj.to_matrix(4))
        for L in (5, 7):
            Wt = tenv.stack_W(Ht, L, None, "cpu")
            assert np.array_equal(Wt.numpy(), np.asarray(jenv.stack_W(Hj, L)))
    # MPO algebra: sum, scalar product and energy shift
    a, b = _models(tham)[:2], _models(jham)[:2]
    for Ht, Hj in (((a[0] + a[1]) * 0.5 + 2.0, (b[0] + b[1]) * 0.5 + 2.0),):
        assert np.array_equal(Ht.W, np.asarray(Hj.W))


def test_finite_mps_layout_matches_jax():
    L, d, D = 7, 2, 6
    assert np.array_equal(tmps.physical_bond_dims(L, d, D),
                          jmps.physical_bond_dims(L, d, D))
    assert np.array_equal(tmps.support_mask(L, d, D),
                          jmps.support_mask(L, d, D))
    for a, b in zip(tdmrg.bulk_rank_flags(L, d, D),
                    jdmrg.bulk_rank_flags(L, d, D)):
        assert np.array_equal(a, np.asarray(b))
    As = _rand(np.random.default_rng(3), (L, D, d, D), np.complex128)
    As = As * tmps.support_mask(L, d, D)
    pt = tmps.FiniteMPS.from_tensors(_t(As))
    pj = jmps.FiniteMPS.from_tensors(jnp.asarray(As))
    for a, b in ((pt.ARs, pj.ARs), (pt.AC, pj.AC)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    qt, qj = pt.move_center(4), pj.move_center(4)
    for a, b in ((qt.ALs[:4], qj.ALs[:4]), (qt.AC, qj.AC),
                 (qt.ARs[5:], qj.ARs[5:])):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    np.testing.assert_allclose(_np(qt.move_center(1).AC),
                               _np(qj.move_center(1).AC), **TOL)
    assert abs(float(qt.norm()) - 1.0) <= 1e-12
    carried = finite_mps_from_numpy(np.asarray(qj.ALs), np.asarray(qj.ARs),
                                    np.asarray(qj.AC), qj.center, "cpu")
    assert carried.center == 4 and torch.equal(carried.AC, _t(qj.AC))


def test_transfer_and_environments_match_jax():
    rng = np.random.default_rng(4)
    L, d, D = 6, 2, 5
    Hj = jham.transverse_field_ising_lattice(g=1.5)
    Ht = mpo_from_numpy(np.asarray(Hj.W))
    Wj = jenv.stack_W(Hj, L)
    Wt = tenv.stack_W(Ht, L, torch.complex128, "cpu")
    w = Wt.shape[1]
    As = _rand(rng, (L, D, d, D), np.complex128)
    Bs = _rand(rng, (L, D, d, D), np.complex128)
    GL, GR, v = (_rand(rng, s, np.complex128)
                 for s in ((w, D, D), (w, D, D), (D, D)))
    for tf, jf, env in ((ttr.transfer_left_mpo, jtr.transfer_left_mpo, GL),
                        (ttr.transfer_right_mpo, jtr.transfer_right_mpo, GR)):
        np.testing.assert_allclose(
            _np(tf(_t(env), Wt[2], _t(As[2]), _t(Bs[2]))),
            _np(jf(jnp.asarray(env), Wj[2], As[2], Bs[2])), **TOL)
    for tf, jf in ((ttr.transfer_left, jtr.transfer_left),
                   (ttr.transfer_right, jtr.transfer_right)):
        np.testing.assert_allclose(_np(tf(_t(v), _t(As[1]), _t(Bs[1]))),
                                   _np(jf(v, As[1], Bs[1])), **TOL)
    GLs_t = tenv.compute_left_envs(
        _t(As), Wt, tenv.left_boundary(w, D, torch.complex128, "cpu"))
    GLs_j = jenv.compute_left_envs(
        As, Wj, jenv.left_boundary(w, D, jnp.complex128))
    GRs_t = tenv.compute_right_envs(
        _t(As), Wt, tenv.right_boundary(w, D, torch.complex128, "cpu"))
    GRs_j = jenv.compute_right_envs(
        As, Wj, jenv.right_boundary(w, D, jnp.complex128))
    np.testing.assert_allclose(_np(GLs_t), _np(GLs_j), **TOL)
    np.testing.assert_allclose(_np(GRs_t), _np(GRs_j), **TOL)


def test_updatetol_matches_jax():
    for eps, it in ((1.0, 1), (3e-3, 4), (1e-20, 9), (1e-7, 2)):
        assert abs(ttols.updatetol(eps, it)
                   - float(jtols.updatetol(eps, it))) <= 1e-20


def test_port_imports_no_jax():
    """Importing every module of the port loads no jax module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mpskit_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'mpskit_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'mpskit_tpu' or m.startswith('mpskit_tpu.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
