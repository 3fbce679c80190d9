"""The finite DMRG slice of the PyTorch port against the JAX package and
against exact energies.

- One `_dmrg_sweep_impl` from a state made by the JAX package and carried
  across with `interop`: energy, Schmidt values at the chain's centre and
  the overlap of the two resulting states, all gauge-invariant.
- `find_groundstate` on small chains against exact diagonalization and
  against the closed-form TFIM energy."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import dmrg as jdmrg
from mpskit_tpu.environments import finite as jenv
from mpskit_tpu.models import hamiltonians as jham
from mpskit_tpu.states import finitemps as jmps
from mpskit_tpu_torch import (
    DMRG, FiniteMPS, expectation_value, find_groundstate, heisenberg_XXX,
    transverse_field_ising, transverse_field_ising_lattice,
)
from mpskit_tpu_torch.algorithms.dmrg import _dmrg_sweep_impl
from mpskit_tpu_torch.environments.finite import (
    compute_right_envs, right_boundary, stack_W,
)
from mpskit_tpu_torch.interop import finite_mps_from_numpy, mpo_from_numpy

torch.set_num_threads(1)

# the JAX sweep without buffer donation, so its inputs stay readable
_jax_sweep = partial(jax.jit, static_argnums=(6, 7),
                     static_argnames=("reorth", "use_fast", "cheap_galerkin")
                     )(jdmrg._dmrg_sweep_impl)


def _center_schmidt(ALs, ARs, AC, L):
    """Schmidt values on the bond right of site L//2 - 1 of a state with
    center 0 (numpy, host)."""
    psi = finite_mps_from_numpy(ALs, ARs, AC, 0).move_center(L // 2 - 1)
    D = AC.shape[0]
    return np.linalg.svd(psi.AC.reshape(-1, D).numpy(), compute_uv=False)


def _overlap(a, b):
    """|<a|b>| of two center-0 states given as (AC, ARs) numpy pairs."""
    (ACa, ARa), (ACb, ARb) = a, b
    v = np.einsum("xsm,xsn->mn", ACa.conj(), ACb)
    for i in range(1, ARa.shape[0]):
        v = np.einsum("xy,xsm,ysn->mn", v, ARa[i].conj(), ARb[i])
    return abs(v[0, 0])


@pytest.mark.parametrize("cheap_galerkin", [True, False])
def test_one_sweep_matches_jax(cheap_galerkin):
    L, d, D, g = 8, 2, 16, 1.5
    dt = np.float64
    Hj = jham.transverse_field_ising_lattice(g=g, dtype=dt)
    pj = jmps.FiniteMPS.random(jax.random.PRNGKey(5), L, d, D, dtype=dt)
    Wsj = jenv.stack_W(Hj, L).astype(dt)
    w = Wsj.shape[1]
    GRsj = jenv.compute_right_envs(pj.ARs, Wsj,
                                   jenv.right_boundary(w, D, dt))
    masks = jmps.support_mask(L, d, D)
    inner_tol = 1e-6
    ALj, ARj, ACj, _, lamj, _, _ = _jax_sweep(
        pj.ALs, pj.ARs, pj.AC, Wsj, GRsj, jnp.asarray(inner_tol), 10, 4,
        masks=jnp.asarray(masks), cheap_galerkin=cheap_galerkin)

    pt = finite_mps_from_numpy(np.asarray(pj.ALs), np.asarray(pj.ARs),
                               np.asarray(pj.AC), 0)
    Wst = stack_W(mpo_from_numpy(np.asarray(Hj.W)), L, torch.float64)
    GRst = compute_right_envs(pt.ARs, Wst, right_boundary(w, D, torch.float64))
    np.testing.assert_allclose(GRst.numpy(), np.asarray(GRsj),
                               rtol=1e-12, atol=1e-12)
    ALt, ARt, ACt, _, lamt, _, _ = _dmrg_sweep_impl(
        pt.ALs, pt.ARs, pt.AC, Wst, GRst, inner_tol, 10, 4,
        masks=torch.from_numpy(masks), cheap_galerkin=cheap_galerkin)

    assert abs(lamt - float(lamj)) <= 1e-10
    ALj, ARj, ACj = (np.asarray(a) for a in (ALj, ARj, ACj))
    np.testing.assert_allclose(
        _center_schmidt(ALt.numpy(), ARt.numpy(), ACt.numpy(), L),
        _center_schmidt(ALj, ARj, ACj, L), rtol=0, atol=1e-8)
    assert _overlap((ACj, ARj), (ACt.numpy(), ARt.numpy())) >= 1 - 1e-10


def _ed_energy(H, L):
    return float(np.linalg.eigvalsh(H.to_matrix(L))[0])


@pytest.mark.parametrize("model", ["tfim", "heisenberg"])
def test_find_groundstate_matches_ed(model):
    L, D = 8, 16
    H = (transverse_field_ising(g=1.2) if model == "tfim"
         else heisenberg_XXX(spin=0.5))
    gen = torch.Generator().manual_seed(0)
    psi = FiniteMPS.random(L, 2, D, torch.complex128, "cpu", gen)
    psi, envs, eps = find_groundstate(psi, H, DMRG(tol=1e-10, maxiter=50))
    E = float(expectation_value(psi, H, envs))
    assert abs(E - _ed_energy(H, L)) <= 1e-8
    assert eps < 1e-8


def test_find_groundstate_matches_tfim_closed_form():
    """The benchmark's solver settings in float64 at L=16 against
    E0 = -sum svdvals(g I + superdiag(1)), the free-fermion energy of the
    open chain (checked here against ED at L=8)."""
    def e0(L, g):
        A = g * np.eye(L) + np.diag(np.ones(L - 1), 1)
        return -np.linalg.svd(A, compute_uv=False).sum()

    H = transverse_field_ising_lattice(g=1.5)
    assert abs(e0(8, 1.5) - _ed_energy(H, 8)) <= 1e-12
    L = 16
    gen = torch.Generator().manual_seed(1)
    psi = FiniteMPS.random(L, 2, 32, torch.float64, "cpu", gen)
    alg = DMRG(krylovdim=10, eig_maxrestarts=2, cheap_galerkin=True,
               maxiter=20, verbosity=0)
    psi, envs, eps = find_groundstate(psi, H, alg)
    assert abs(float(expectation_value(psi, H, envs)) - e0(L, 1.5)) <= 1e-8
