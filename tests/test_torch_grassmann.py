"""GradientGrassmann in the PyTorch port against the JAX package: the
preconditioned tangent gradient, one CG step, the finite solver, and the
reference's ground-state quality gate on the port alone (the default
infinite `find_groundstate` has a file of its own,
test_torch_grassmann_default.py).

States are made by the port from a seed and carried into the JAX package
(or the reverse), in float64 / complex128."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import grassmann as jgr
from mpskit_tpu.models import hamiltonians as jham
from mpskit_tpu.states import finitemps as jmps
from mpskit_tpu.states import infinitemps as jimps
from mpskit_tpu_torch import (
    VUMPS, FiniteMPS, GradientGrassmann, InfiniteMPS, expectation_value,
    find_groundstate, transverse_field_ising,
)
from mpskit_tpu_torch.algorithms import grassmann as tgr
from mpskit_tpu_torch.algorithms.derivatives import ac2_apply
from mpskit_tpu_torch.environments.finite import stack_W
from mpskit_tpu_torch.interop import mpo_from_numpy
from mpskit_tpu_torch.states.quasiparticle import null_spaces
from mpskit_tpu_torch.tensors.ops import rightnull

jfg = importlib.import_module("mpskit_tpu.algorithms.find_groundstate")

torch.set_num_threads(1)


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _to_jax(pt):
    return jimps.InfiniteMPS(*(jnp.asarray(_np(x))
                               for x in (pt.AL, pt.AR, pt.AC, pt.C)))


def _tfim(g):
    Hj = jham.transverse_field_ising_lattice(g=g)
    return mpo_from_numpy(np.asarray(Hj.W)), Hj


@pytest.mark.parametrize("L,dtype", [(1, torch.float64),
                                     (2, torch.complex128)])
def test_energy_and_gradient_match_jax(L, dtype):
    """The energy density and the preconditioned, projected gradient
    elementwise from one state, and the gradient horizontal (AL^dag G =
    0)."""
    Ht, Hj = _tfim(1.5)
    pt = InfiniteMPS.random(L, 2, 5, dtype, "cpu",
                            torch.Generator().manual_seed(L))
    e_t, g_t, _ = tgr._energy_and_gradient(pt, Ht, 1e-12)
    e_j, g_j, _ = jgr._energy_and_gradient(_to_jax(pt), Hj, 1e-12)
    assert abs(float(e_t) - float(e_j)) <= 1e-12
    np.testing.assert_allclose(_np(g_t), np.asarray(g_j), rtol=0, atol=1e-10)
    z = torch.einsum("ilpm,ilpk->imk", pt.AL.conj(), g_t)
    assert float(z.abs().max()) <= 1e-12


def _count_cg_steps(monkeypatch):
    """A list that grows by one at every accepted CG step (each calls
    `_cg_beta` once)."""
    steps, beta = [], tgr._cg_beta

    def counted(*args):
        steps.append(1)
        return beta(*args)
    monkeypatch.setattr(tgr, "_cg_beta", counted)
    return steps


def test_one_cg_step_matches_jax(monkeypatch):
    """maxiter=1: the same line search from one state gives the same
    energy density and retracted AL."""
    steps = _count_cg_steps(monkeypatch)
    Ht, Hj = _tfim(1.5)
    pt = InfiniteMPS.random(1, 2, 5, torch.float64, "cpu",
                            torch.Generator().manual_seed(1))
    alg_t = GradientGrassmann(maxiter=1, verbosity=0)
    alg_j = jgr.GradientGrassmann(maxiter=1, verbosity=0)
    qt, et, gt = tgr.find_groundstate_grassmann(pt, Ht, alg_t)
    qj, ej, gj = jgr.find_groundstate_grassmann(_to_jax(pt), Hj, alg_j)
    assert len(steps) == 1
    assert abs(float(et.e_density) - float(ej.e_density)) <= 1e-10
    np.testing.assert_allclose(_np(qt.AL), np.asarray(qj.AL), rtol=0,
                               atol=1e-10)
    assert abs(gt - float(gj)) <= 1e-10


def test_finite_grassmann_matches_jax():
    """Ten CG iterations of the finite solver from one padded state: the
    energies to 1e-10 and the returned state's energy."""
    Hj = jham.transverse_field_ising(g=1.5)
    Ht = mpo_from_numpy(np.asarray(Hj.W))
    pt = FiniteMPS.random(6, 2, 4, torch.float64, "cpu",
                          torch.Generator().manual_seed(5))
    pj = jmps.FiniteMPS(*(jnp.asarray(_np(x))
                          for x in (pt.ALs, pt.ARs, pt.AC)), pt.center)
    qt, _, gt = find_groundstate(pt, Ht, GradientGrassmann(maxiter=10,
                                                            verbosity=0))
    qj, _, gj = jfg.find_groundstate(pj, Hj, jgr.GradientGrassmann(
        maxiter=10, verbosity=0))
    from mpskit_tpu.algorithms.expval import expectation_value as jexpval

    e_t, e_j = float(expectation_value(qt, Ht)), float(jexpval(qj, Hj))
    assert abs(e_t - e_j) <= 1e-10
    assert abs(gt - float(gj)) <= 1e-8
    assert qt.AC.shape == (4, 2, 4) and qt.center == 0


def _mps_vector(psi):
    p = psi.move_center(0)
    v = p.AC[:1].numpy()
    for i in range(1, psi.length):
        v = np.tensordot(v, p.ARs[i].numpy(), axes=1)
    return v[..., :1].reshape(-1)


def _infinite_variance(psi, H, envs):
    """The two-site tangent variance density (the JAX package's
    `toolbox.variance` for an InfiniteMPS)."""
    Ws = stack_W(H, psi.period, psi.dtype, "cpu")
    VLs = null_spaces(psi.AL)
    total = 0.0
    for i in range(psi.period):
        j = (i + 1) % psi.period
        theta = torch.einsum("lpm,mqr->lpqr", psi.AC[i], psi.AR[j])
        h2 = ac2_apply(envs.GLs[i], Ws[i], Ws[j], envs.GRs[j], theta)
        M = torch.einsum("lpk,lpqr,mqr->km", VLs[i].conj(), h2,
                         rightnull(psi.AR[j]).conj())
        total += float((M.abs() ** 2).sum())
    return total


@pytest.mark.parametrize("finite", [True, False])
def test_grassmann_quality_gate(finite):
    """The reference's gate (tests/test_groundstate_gate.py): TFIM g=4,
    D=6, GradientGrassmann(tol=1e-6), the convergence measure below 1e-2
    and the energy variance below 1e-2, through find_groundstate. The
    finite chain is the gate's L=10 from a random state, bounded at 150
    iterations (eps 2.3e-3 there; the gate's 500 take a minute on one CPU
    thread). The infinite solver starts after two VUMPS iterations: from a
    random state its line search gives up at eps 0.1-2 in both packages
    (seeds 0-3, ROADMAP.md queue 3)."""
    H = transverse_field_ising(g=4.0)
    gen = torch.Generator().manual_seed(0)
    if finite:
        L = 10
        psi = FiniteMPS.random(L, 2, 6, torch.complex128, "cpu", gen)
        psi, envs, eps = find_groundstate(psi, H, GradientGrassmann(
            tol=1e-6, maxiter=150, verbosity=0))
        v = _mps_vector(psi)
        Hm = H.to_matrix(L)
        var = np.linalg.norm(Hm @ v) ** 2 - np.vdot(v, Hm @ v).real ** 2
    else:
        psi = InfiniteMPS.random(1, 2, 6, torch.complex128, "cpu", gen)
        psi, envs, eps = find_groundstate(
            psi, H, VUMPS(maxiter=2, verbosity=0)
            & GradientGrassmann(tol=1e-6, maxiter=300, verbosity=0))
        var = _infinite_variance(psi, H, envs)
    assert eps < 1e-2
    assert abs(var) < 1e-2
