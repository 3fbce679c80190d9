"""The abelian (U(1) / Z_n) symmetric states of the PyTorch port against
the JAX package on the CPU, float64: bond charge labels and masks, the
sector one-site DMRG, the sector-resolved two-site DMRG, the sector
VUMPS, the sector entanglement spectra and the sector-resolved transfer
spectrum. Both packages start from the same numbers: the JAX states are
made from PRNGKeys and carried across with `interop` (their random
generators differ)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import expectation_value as jexpval
from mpskit_tpu.algorithms.dmrg import DMRG as JDMRG
from mpskit_tpu.algorithms.dmrg2 import DMRG2 as JDMRG2
from mpskit_tpu.algorithms.toolbox import transfer_spectrum as jtransfer
from mpskit_tpu.algorithms.vumps import VUMPS as JVUMPS
from mpskit_tpu.models import hamiltonians as jham
from mpskit_tpu.symmetry import charges as jch
from mpskit_tpu_torch import (
    DMRG, DMRG2, VUMPS, expectation_value, find_groundstate,
    heisenberg_XXX, transfer_spectrum, transverse_field_ising_parity,
)
from mpskit_tpu_torch.interop import (
    symmetric_finite_mps_from_numpy, symmetric_infinite_mps_from_numpy,
)
from mpskit_tpu_torch.symmetry import charges as tch

torch.set_num_threads(1)

SZ = np.diag([0.5, -0.5])


def _carry_finite(sj):
    p = sj.state
    return symmetric_finite_mps_from_numpy(
        *(np.asarray(x) for x in (p.ALs, p.ARs, p.AC)), p.center,
        sj.bond_charges, sj.phys_charges, sj.modulus, device="cpu")


def _carry_infinite(sj):
    p = sj.state
    return symmetric_infinite_mps_from_numpy(
        *(np.asarray(x) for x in (p.AL, p.AR, p.AC, p.C)), sj.bond_charges,
        sj.phys_charges, sj.modulus, device="cpu")


def _leak(t, mask):
    return float((t * ~torch.as_tensor(mask)).abs().max())


def _ed_sector_energy(H, L, sz2_total):
    """Lowest eigenvalue in the sector sum(2 Sz_i) = sz2_total (basis index
    0 is spin up, site 0 the most significant factor)."""
    M = H.to_matrix(L)
    bits = (np.arange(2 ** L)[:, None] >> np.arange(L - 1, -1, -1)) & 1
    idx = np.where((1 - 2 * bits).sum(1) == sz2_total)[0]
    return float(np.linalg.eigvalsh(M[np.ix_(idx, idx)])[0])


@pytest.mark.parametrize("L,D,total,modulus,phys,aux", [
    (8, 16, 0, None, (1, -1), None), (7, 6, 3, None, (1, -1), None),
    (10, 12, 0, 2, (0, 1), None), (9, 8, 1, 3, (0, 1), None),
    (6, 10, 2, None, (0, 1), None), (8, 8, 0, None, (0, 1), (-1, 0))])
def test_labels_and_masks_match_jax(L, D, total, modulus, phys, aux):
    """assign_bond_charges, charge_masks_finite and flux_masks_finite equal
    the JAX package's (np.array_equal), labels int64 on the host."""
    a = jch.assign_bond_charges(L, phys, D, total, aux_charges=aux,
                                modulus=modulus)
    b = tch.assign_bond_charges(L, phys, D, total, aux_charges=aux,
                                modulus=modulus)
    assert len(a) == len(b) == L + 1
    for x, y in zip(a, b):
        assert y.dtype == np.int64 and np.array_equal(x, y)
    assert np.array_equal(
        jch.charge_masks_finite(a, phys, aux_charges=aux, modulus=modulus),
        tch.charge_masks_finite(b, phys, aux_charges=aux, modulus=modulus))
    for sector in (0, 1):
        assert np.array_equal(
            jch.flux_masks_finite(a, phys, sector, modulus=modulus),
            tch.flux_masks_finite(b, phys, sector, modulus=modulus))


@pytest.mark.parametrize("L,D,phys,modulus", [
    (2, 12, (1, -1), None), (1, 10, (0, 1), 2), (2, 9, (0, 1), None),
    (3, 8, (0, 1, 2), 3)])
def test_uniform_labels_and_masks_match_jax(L, D, phys, modulus):
    """uniform_bond_charges_cell and uniform_charge_masks equal the JAX
    package's; the port's random SymmetricInfiniteMPS is on its masks."""
    a = jch.uniform_bond_charges_cell(L, D, phys, modulus=modulus)
    b = tch.uniform_bond_charges_cell(L, D, phys, modulus=modulus)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for x, y in zip(jch.uniform_charge_masks(a, phys, modulus=modulus),
                    tch.uniform_charge_masks(b, phys, modulus=modulus)):
        assert np.array_equal(x, y)
    s = tch.SymmetricInfiniteMPS.random(L, phys, D, torch.complex128,
                                        modulus, "cpu",
                                        torch.Generator().manual_seed(1))
    A_mask, C_mask = s.masks
    assert s.state.device.type == "cpu"
    assert _leak(s.state.AL, A_mask) == 0 == _leak(s.state.C, C_mask)


@functools.lru_cache(maxsize=None)
def _xxx_groundstate(total):
    """The JAX package's sector ground state of the spin-1/2 XXX chain
    (L=8, D=16, float64) and the port's from the same start."""
    H = jham.heisenberg_XXX(spin=0.5)
    sj = jch.SymmetricFiniteMPS.random(jax.random.PRNGKey(total), 8, [1, -1],
                                       16, total=total, dtype=jnp.float64)
    st = _carry_finite(sj)
    outj, envsj, _ = jch.find_groundstate_symmetric(
        sj, H, JDMRG(tol=1e-10, maxiter=30))
    outt, envst, eps = find_groundstate(st, heisenberg_XXX(spin=0.5),
                                        DMRG(tol=1e-10, maxiter=30))
    Ej = float(jexpval(outj.state, H, envs=envsj))
    Et = float(expectation_value(outt.state, heisenberg_XXX(spin=0.5),
                                 envs=envst))
    return outj, outt, Ej, Et, eps


@pytest.mark.parametrize("total", [0, 2])
def test_find_groundstate_symmetric_matches_jax(total):
    """Sector DMRG (through find_groundstate) in Sz_tot = 0 and 1: the
    energy within 1e-10 of the JAX package's and 1e-8 of the sector ED,
    <Sz_tot> exact, and every tensor exactly zero outside the charge
    mask."""
    _, outt, Ej, Et, eps = _xxx_groundstate(total)
    assert abs(Et - Ej) < 1e-10 and eps < 1e-9
    assert abs(Et - _ed_sector_energy(heisenberg_XXX(spin=0.5), 8,
                                      total)) < 1e-8
    psi = outt.state
    sz = sum(complex(expectation_value(psi, (i, SZ))).real for i in range(8))
    assert abs(sz - total / 2) < 1e-9
    m = outt.masks
    assert _leak(psi.ALs[:-1], m[:-1]) == 0 == _leak(psi.ARs[1:], m[1:])
    assert _leak(psi.AC, m[0]) == 0


def test_find_groundstate_symmetric_z2():
    """A Z_2 state (modulus 2): the parity TFIM g=1.5 at L=8 D=8, energy
    within 1e-10 of the JAX package's."""
    Hj = jham.transverse_field_ising_parity(g=1.5, dtype=np.float64)
    sj = jch.SymmetricFiniteMPS.random(jax.random.PRNGKey(4), 8, (0, 1), 8,
                                       total=0, dtype=jnp.float64, modulus=2)
    outj, envsj, _ = jch.find_groundstate_symmetric(
        sj, Hj, JDMRG(tol=1e-10, maxiter=30))
    H = transverse_field_ising_parity(g=1.5)
    outt, envst, _ = tch.find_groundstate_symmetric(
        _carry_finite(sj), H, DMRG(tol=1e-10, maxiter=30))
    assert outt.modulus == 2
    assert abs(float(expectation_value(outt.state, H, envs=envst))
               - float(jexpval(outj.state, Hj, envs=envsj))) < 1e-10
    assert _leak(outt.state.ARs[1:], outt.masks[1:]) == 0


def test_find_groundstate_symmetric_dmrg2_matches_jax():
    """Sector-resolved DMRG2 (through find_groundstate with DMRG2) on the
    XXX chain L=8 D=16: the same dynamic bond labels as the JAX package's
    and the energy within 1e-10 of it and of the sector ED."""
    H = jham.heisenberg_XXX(spin=0.5)
    sj = jch.SymmetricFiniteMPS.random(jax.random.PRNGKey(0), 8, (1, -1), 16,
                                       total=0, dtype=jnp.float64)
    outj, _, _ = jch.find_groundstate_symmetric_dmrg2(
        sj, H, JDMRG2(tol=1e-11, maxiter=10, verbosity=0))
    Ht = heisenberg_XXX(spin=0.5)
    outt, envst, _ = find_groundstate(_carry_finite(sj), Ht,
                                      DMRG2(tol=1e-11, maxiter=10,
                                            verbosity=0))
    for a, b in zip(outj.bond_charges, outt.bond_charges):
        assert np.array_equal(a, b)
    Ej = float(np.real(np.asarray(jexpval(outj.state, H)).sum()))
    Et = float(expectation_value(outt.state, Ht, envs=envst))
    assert abs(Et - Ej) < 1e-10
    assert abs(Et - _ed_sector_energy(Ht, 8, 0)) < 1e-10


@pytest.mark.parametrize("total", [0, 1])
def test_find_groundstate_symmetric_dmrg2_z2(total):
    """Sector-resolved DMRG2 of a Z_2 state (the parity TFIM g=1.5, L=8,
    D=8, modulus 2) splits by charges mod 2 and keeps the modulus: the
    energy within 1e-10 of the parity sector's ED and every tensor exactly
    zero outside the Z_2 masks. (The JAX package splits by unreduced
    charges and returns the state with U(1) masks.)"""
    sj = jch.SymmetricFiniteMPS.random(jax.random.PRNGKey(5), 8, (0, 1), 8,
                                       total=total, dtype=jnp.float64,
                                       modulus=2)
    H = transverse_field_ising_parity(g=1.5)
    outt, envst, _ = find_groundstate(_carry_finite(sj), H,
                                      DMRG2(tol=1e-11, maxiter=20,
                                            verbosity=0))
    assert outt.modulus == 2
    bits = (np.arange(2 ** 8)[:, None] >> np.arange(8)) & 1
    keep = bits.sum(axis=1) % 2 == total
    e0 = float(np.linalg.eigvalsh(H.to_matrix(8)[np.ix_(keep, keep)])[0])
    Et = float(expectation_value(outt.state, H, envs=envst))
    assert abs(Et - e0) < 1e-10
    psi, m = outt.state, outt.masks
    assert _leak(psi.ALs[:-1], m[:-1]) == 0 == _leak(psi.ARs[1:], m[1:])
    assert _leak(psi.AC, m[0]) == 0


def test_symmetric_infinite_vumps_matches_jax():
    """Sector VUMPS (through find_groundstate) of the XXX chain on a
    two-site cell (charges +-1), D=8 float64, 30 iterations: the energy
    density and eps within 1e-10 of the JAX package's, C exactly zero
    outside its mask."""
    H = jham.heisenberg_XXX(spin=0.5)
    sj = jch.SymmetricInfiniteMPS.random(jax.random.PRNGKey(0), 2, [1, -1],
                                         8, dtype=jnp.float64)
    outj, envsj, epsj = jch.find_groundstate_symmetric_infinite(
        sj, H, JVUMPS(tol=1e-10, maxiter=30))
    outt, envst, epst = find_groundstate(
        _carry_infinite(sj), heisenberg_XXX(spin=0.5),
        VUMPS(tol=1e-10, maxiter=30))
    assert abs(float(envst.e_density) - float(envsj.e_density)) < 1e-10
    assert abs(epst - float(epsj)) < 1e-10
    A_mask, C_mask = outt.masks
    assert _leak(outt.state.C, C_mask) == 0 == _leak(outt.state.AL, A_mask)


def test_sector_entanglement_spectra_match_jax():
    """sector_entanglement_spectrum at every inner bond of the XXX ground
    state and sector_entanglement_spectrum_infinite at both cell bonds of
    a random two-site state: the same sectors and Schmidt values as the
    JAX package's (1e-10), summing to 1 in the finite case."""
    outj, outt, _, _, _ = _xxx_groundstate(0)
    for bond in range(1, 8):
        a = jch.sector_entanglement_spectrum(outj, bond)
        b = tch.sector_entanglement_spectrum(outt, bond)
        assert sorted(a) == sorted(b)
        for q in a:
            np.testing.assert_allclose(np.sort(b[q]), np.sort(a[q]),
                                       rtol=0, atol=1e-10)
        total = sum(float(np.sum(v ** 2)) for v in b.values())
        assert abs(total - 1) < 1e-10
    sj = jch.SymmetricInfiniteMPS.random(jax.random.PRNGKey(3), 2, [1, -1],
                                         10, dtype=jnp.float64)
    st = _carry_infinite(sj)
    for bond in (0, 1, -1):
        a = jch.sector_entanglement_spectrum_infinite(sj, bond)
        b = tch.sector_entanglement_spectrum_infinite(st, bond)
        assert sorted(a) == sorted(b) and len(b) >= 2
        for q in a:
            np.testing.assert_allclose(np.sort(b[q]), np.sort(a[q]),
                                       rtol=0, atol=1e-10)


def test_transfer_spectrum_sectors():
    """transfer_spectrum(sector=q) of a random two-site state (D=12,
    float64) against the dense cell transfer matrix restricted to flux q
    and against the JAX package (the two leading magnitudes, 1e-8); the
    untwisted channel carries lambda_0 = 1 (1e-10)."""
    D = 12
    sj = jch.SymmetricInfiniteMPS.random(jax.random.PRNGKey(2), 2, [1, -1], D,
                                         dtype=jnp.float64)
    st = _carry_infinite(sj)
    AL = np.asarray(sj.state.AL)
    T = np.eye(D * D)
    for i in range(2):
        T = np.einsum("xpm,ypn->mnxy", AL[i].conj(), AL[i]).reshape(
            D * D, D * D) @ T
    labels = sj.bond_charges[-1]
    for q in (0, 2, -2):
        idx = np.where(((labels[:, None] - labels[None, :]) == q)
                       .reshape(-1))[0]
        dense = np.sort(np.abs(np.linalg.eigvals(T[np.ix_(idx, idx)])))[::-1]
        lt = transfer_spectrum(st, num=3, krylovdim=40, sector=q)
        assert lt.device.type == "cpu" and lt.dtype == torch.complex128
        lj = np.abs(np.asarray(jtransfer(sj, num=3, krylovdim=40, sector=q)))
        np.testing.assert_allclose(np.abs(lt.numpy())[:2], dense[:2],
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(np.abs(lt.numpy())[:2], lj[:2], rtol=0,
                                   atol=1e-8)
    lam0 = transfer_spectrum(st, num=1, sector=0)
    assert abs(abs(complex(lam0[0])) - 1.0) < 1e-10
    # without a sector the symmetric state's plain spectrum
    assert abs(abs(complex(transfer_spectrum(st, num=1)[0])) - 1) < 1e-10


@pytest.mark.parametrize("reorth", ["full", "local", "local1"])
def test_single_precision_lanczos_in_a_small_sector(reorth):
    """A float32 solve whose start vector lies in a 3-dimensional invariant
    block (a charge sector smaller than the Krylov dimension 10) returns
    that block's lowest eigenpair: once the block is exhausted the next
    beta is float32 rounding noise, which the breakdown threshold of
    `eigsh_smallest` must catch (with the float64 threshold 1e-14 the
    `full` recurrence returned -70 for a block whose lowest eigenvalue is
    -2.26)."""
    from mpskit_tpu_torch.linalg.lanczos import eigsh_smallest

    rng = np.random.default_rng(0)
    n, k = 64, 3
    A = rng.standard_normal((n, n))
    A = A + A.T
    A[:k, k:] = 0
    A[k:, :k] = 0
    H = torch.from_numpy(A).float()
    v0 = torch.zeros(n)
    v0[:k] = torch.from_numpy(rng.standard_normal(k)).float()
    exact = float(np.linalg.eigvalsh(A[:k, :k])[0])
    res = eigsh_smallest(lambda x: H @ x, v0, 10, 3, 1e-6, reorth=reorth)
    x = res.eigenvector / res.eigenvector.norm()
    assert abs(res.eigenvalue - exact) < 1e-5
    assert abs(float(x @ H @ x) - exact) < 1e-5
    assert float(x[k:].abs().max()) == 0.0


def test_float32_sector_dmrg_keeps_its_sector():
    """float32 sector DMRG of the XX chain (free fermions) at L=32 D=128 in
    the sector N=16, 8 sweeps of krylovdim 10: the energy within 1e-5
    relative of sum_{k<=16} -2 cos(k pi / 33), <N> = 16 to 1e-5, no entry
    off the mask. With the masked QR / LQ in float32 the energy rose
    sweep by sweep to 1.6e-2 above: a float32 Householder QR of the
    interleaved rank-deficient charge blocks put up to 2e-2 of a tensor
    off the mask, which masking dropped; the sweep now splits in
    float64."""
    from mpskit_tpu_torch import SymmetricFiniteMPS, xx_chain_with_field

    L, N, D = 32, 16, 128
    H = xx_chain_with_field(h=0.0)
    s = SymmetricFiniteMPS.random(L, (0, 1), D, N, torch.float32, None,
                                  "cpu", torch.Generator().manual_seed(71))
    s, envs, _ = find_groundstate(s, H, DMRG(krylovdim=10, eig_maxrestarts=2,
                                             tol=1e-6, maxiter=8,
                                             verbosity=0))
    e_ex = float(np.sum(-2 * np.cos(np.arange(1, N + 1) * np.pi / (L + 1))))
    E = float(expectation_value(s.state, H, envs=envs))
    assert abs(E - e_ex) / abs(e_ex) < 1e-5
    n = np.diag([0.0, 1.0])
    Nt = sum(complex(expectation_value(s.state, (i, n))).real
             for i in range(L))
    assert abs(Nt - N) < 1e-5
    m = s.masks
    assert _leak(s.state.AC, m[0]) == 0 == _leak(s.state.ARs[1:], m[1:])
