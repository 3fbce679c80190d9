"""Thermal purifications of the PyTorch port against the JAX package and
the dense Gibbs state on the CPU: the infinite-temperature state (beta =
0), the ket lifts of an MPOHamiltonian and of a DenseMPO, and thermal
energies at beta = 0.4 and 1.2 of the open TFIM (g = 1.2, L = 6).

Both packages evolve |vec 1> by the same host evolution MPO in
complex128; the thermal energy is gauge-invariant, so the packages agree
to 1e-10. Against the dense E(beta) = Tr(H e^{-beta H}) / Tr(e^{-beta H})
the bound is the JAX test's 5e-3 relative (the O(dbeta^2) error of each
MPO step and the truncation to Dmax = 16)."""

import functools
import importlib

import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import timeevmpo as jtev
from mpskit_tpu.models import hamiltonians as jh
from mpskit_tpu_torch import (
    WII, lift_densempo, lift_hamiltonian, make_time_mpo, purification_mps,
    thermal_expectation, thermal_state,
)
from mpskit_tpu_torch.interop import mpo_from_numpy

jth = importlib.import_module("mpskit_tpu.algorithms.thermal")

torch.set_num_threads(1)

# DMAX 16 cuts the purification's middle bond (64)
L, G, DMAX, DBETA = 6, 1.2, 16, 0.025


@functools.cache
def _H():
    Hj = jh.transverse_field_ising(g=G, dtype=np.complex128)
    return Hj, mpo_from_numpy(np.asarray(Hj.W))


@pytest.fixture(scope="module", autouse=True)
def _one_jax_time_mpo():
    """The JAX package's `make_time_mpo` builds the WII MPO anew in every
    `thermal_state` call, 21 XLA compilations (~8 s, minutes on a loaded
    CPU): the module builds it once per (H, dt, algorithm) and hands the
    same MPO to every call, which is what a fresh build returns."""
    jtev_mod = importlib.import_module("mpskit_tpu.algorithms.timeevmpo")
    build = jtev_mod.make_time_mpo
    built = {}

    def once(H, dt, alg):
        key = (id(H), dt, type(alg))
        if key not in built:
            built[key] = build(H, dt, alg)
        return built[key]

    jtev_mod.make_time_mpo = once
    yield
    jtev_mod.make_time_mpo = build


def _gibbs_energy(H, beta):
    w = np.linalg.eigvalsh(H.to_matrix(L))
    z = np.exp(-beta * (w - w.min()))
    return float((w * z).sum() / z.sum())


def test_infinite_temperature():
    """beta = 0: |vec 1> has <H> = Tr(H) / 2^L = 0 in both packages; the
    state is normalized, on the CPU as asked, with physical dimension 4."""
    Hj, Ht = _H()
    psi = purification_mps(2, L, 8, device="cpu")
    assert psi.physicaldim == 4 and psi.AC.device.type == "cpu"
    assert abs(float(psi.norm()) - 1) <= 1e-14
    e_t = float(thermal_expectation(psi, Ht))
    e_j = float(jth.thermal_expectation(jth.purification_mps(2, L, 8), Hj))
    assert abs(e_t) <= 1e-10 and abs(e_t - e_j) <= 1e-10
    out = thermal_state(Ht, L, 0.0, DBETA, 8, device="cpu")
    assert abs(float(thermal_expectation(out, Ht))) <= 1e-10


def test_lifts():
    """lift_hamiltonian and lift_densempo give the JAX package's arrays."""
    Hj, Ht = _H()
    np.testing.assert_array_equal(lift_hamiltonian(Ht).W,
                                  np.asarray(jth.lift_hamiltonian(Hj).W))
    U_t = lift_densempo(make_time_mpo(Ht, -1j * DBETA, WII()))
    U_j = jth.lift_densempo(jtev.make_time_mpo(Hj, -1j * DBETA, jtev.WII()))
    assert U_t.period == len(U_j.Os)
    for i in range(U_t.period):
        np.testing.assert_allclose(U_t.site(i), np.asarray(U_j.site(i)),
                                   rtol=0, atol=1e-14)


@pytest.mark.parametrize("beta", [0.4, 1.2])
def test_thermal_energy(beta):
    """E(beta) of the purification: the JAX package's to 1e-10 and the
    dense Gibbs energy within 5e-3 relative."""
    Hj, Ht = _H()
    e_t = float(thermal_expectation(
        thermal_state(Ht, L, beta, DBETA, DMAX, device="cpu"), Ht))
    e_j = float(jth.thermal_expectation(
        jth.thermal_state(Hj, L, beta, DBETA, DMAX), Hj))
    e_ex = _gibbs_energy(Ht, beta)
    assert abs(e_t - e_j) <= 1e-10 * abs(e_j)
    assert abs(e_t - e_ex) <= 5e-3 * max(1.0, abs(e_ex))
    with pytest.raises(ValueError):
        thermal_state(Ht, L, beta, 0.07, DMAX, device="cpu")
