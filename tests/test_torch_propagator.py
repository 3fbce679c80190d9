"""Dynamical DMRG (`propagator`) of the PyTorch port against the JAX
package and against dense linear algebra on the CPU: NaiveInvert and
Jeckelmann on a random state against `np.linalg.solve` of the dense
H, the ground-state pole G(z) = 1 / (z - E0), and the sweep's entry
checks.

The random start psi0 is made by the JAX package from a PRNGKey and
carried across with `interop`; both packages then sweep from the same
numbers in complex128. G(z) is gauge-invariant: 1e-10 between the
packages and against the dense solve (Jeckelmann's squared system is
solved to 1e-8 of the dense value, its normal equations' conditioning)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.models import hamiltonians as jh
from mpskit_tpu.states.finitemps import FiniteMPS as JFiniteMPS
from mpskit_tpu_torch import (
    DMRG, DynamicalDMRG, FiniteMPS, Jeckelmann, NaiveInvert,
    expectation_value, find_groundstate, propagator,
)
from mpskit_tpu_torch.interop import finite_mps_from_numpy, mpo_from_numpy

jprop = importlib.import_module("mpskit_tpu.algorithms.propagator")

torch.set_num_threads(1)

L, D, G, Z = 6, 8, 1.1, 0.7 + 0.4j


def _vector(psi: FiniteMPS) -> np.ndarray:
    p = psi.move_center(0)
    v = p.AC.numpy()[:1]
    for i in range(1, psi.length):
        v = np.einsum("...m,mpr->...pr", v, p.ARs[i].numpy())
    return v[..., :1].reshape(-1)


def _start():
    Hj = jh.transverse_field_ising(g=G)
    pj = JFiniteMPS.random(jax.random.PRNGKey(1), L, 2, D)
    pt = finite_mps_from_numpy(np.asarray(pj.ALs), np.asarray(pj.ARs),
                               np.asarray(pj.AC), pj.center, "cpu")
    return Hj, mpo_from_numpy(np.asarray(Hj.W)), pj, pt


@pytest.mark.parametrize("flavour", ["naive", "jeckelmann"])
def test_propagator_against_jax_and_dense(flavour):
    """G(z) at z = 0.7 + 0.4i from a random psi0: the JAX package's value
    to 1e-10 and <psi0| (z - H)^{-1} |psi0> by the dense solve (1e-10
    NaiveInvert, 1e-8 Jeckelmann); the solution is a complex128 FiniteMPS
    of psi0's shape on the CPU."""
    Hj, Ht, pj, pt = _start()
    quad = flavour == "jeckelmann"
    kw = dict(tol=1e-9, maxiter=60)
    if quad:
        kw["linsolve_tol"] = 1e-11
    G_j, _ = jprop.propagator(pj, Z, Hj, jprop.DynamicalDMRG(
        flavour=jprop.Jeckelmann() if quad else jprop.NaiveInvert(), **kw))
    G_t, sol = propagator(pt, Z, Ht, DynamicalDMRG(
        flavour=Jeckelmann() if quad else NaiveInvert(), **kw), device="cpu")
    v = _vector(pt)
    G_ex = np.vdot(v, np.linalg.solve(Z * np.eye(2 ** L) - Ht.to_matrix(L),
                                      v))
    assert abs(complex(G_t) - complex(G_j)) <= 1e-10
    assert abs(complex(G_t) - G_ex) <= (1e-8 if quad else 1e-10)
    assert sol.AC.dtype == torch.complex128 and sol.AC.device.type == "cpu"
    assert sol.ALs.shape == pt.ALs.shape and sol.center == 0


def test_propagator_ground_state_pole():
    """On the ground state G(z) = 1 / (z - E0): at z = E0 + 0.5 + 0.3i
    within 1e-9 relative, from a float64 state (the sweep promotes it to
    complex128); a start `init` leaves the answer unchanged."""
    H = mpo_from_numpy(np.asarray(jh.transverse_field_ising(g=1.4).W))
    gen = torch.Generator().manual_seed(0)
    psi = FiniteMPS.random(L, 2, D, torch.float64, "cpu", gen)
    psi, envs, _ = find_groundstate(psi, H, DMRG(tol=1e-12, maxiter=50))
    E0 = float(expectation_value(psi, H, envs=envs))
    alg = DynamicalDMRG(tol=1e-10, maxiter=50)
    want = 1 / (0.5 + 0.3j)
    G, _ = propagator(psi, E0 + 0.5 + 0.3j, H, alg, device="cpu")
    assert abs(complex(G) - want) <= 1e-9 * abs(want)
    G2, _ = propagator(psi, E0 + 0.5 + 0.3j, H, alg, init=psi.move_center(3),
                       device="cpu")
    assert abs(complex(G2) - want) <= 1e-9 * abs(want)
