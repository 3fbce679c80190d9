"""Charged-sector quasiparticles of the PyTorch port against the JAX
package on the CPU, float64: `excitations(..., sector=)` on finite
symmetric states (the B-space solve; U(1) single particles above the
vacuum of the XX chain with a field, Z_2 flips of the parity TFIM) and on
an infinite Z_2 state (the X-space flux projector), and the TypeError for
a sector on a plain state. Each package draws its own start vectors, so
the tests compare converged eigenvalues."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms.dmrg import DMRG as JDMRG
from mpskit_tpu.algorithms.excitations import QuasiparticleAnsatz as JQPA
from mpskit_tpu.algorithms.excitations import excitations as jexcitations
from mpskit_tpu.algorithms.vumps import VUMPS as JVUMPS
from mpskit_tpu.models import hamiltonians as jham
from mpskit_tpu.symmetry import charges as jch
from mpskit_tpu_torch import (
    FiniteMPS, InfiniteMPS, QuasiparticleAnsatz, excitations,
    transverse_field_ising_parity, xx_chain_with_field,
)
from mpskit_tpu_torch.interop import (
    symmetric_finite_mps_from_numpy, symmetric_infinite_mps_from_numpy,
)

torch.set_num_threads(1)


def _carry_finite(sj):
    p = sj.state
    return symmetric_finite_mps_from_numpy(
        *(np.asarray(x) for x in (p.ALs, p.ARs, p.AC)), p.center,
        sj.bond_charges, sj.phys_charges, sj.modulus, device="cpu")


@functools.lru_cache(maxsize=None)
def _finite_groundstate(model):
    """The JAX package's sector ground state (L=8) of the XX chain at h=4
    (the N=0 vacuum, D=8) or of the parity TFIM at g=4 (Z_2, D=8)."""
    if model == "xx":
        H = jham.xx_chain_with_field(h=4.0, dtype=np.float64)
        sj = jch.SymmetricFiniteMPS.random(jax.random.PRNGKey(2), 8, (0, 1),
                                           8, total=0, dtype=jnp.float64)
    else:
        H = jham.transverse_field_ising_parity(g=4.0, dtype=np.float64)
        sj = jch.SymmetricFiniteMPS.random(jax.random.PRNGKey(1), 8, (0, 1),
                                           8, total=0, dtype=jnp.float64,
                                           modulus=2)
    sj, _, _ = jch.find_groundstate_symmetric(sj, H, JDMRG(tol=1e-11,
                                                           maxiter=25))
    return H, sj


@pytest.mark.parametrize("model", ["xx", "z2"])
def test_finite_charged_excitations_match_jax(model):
    """Three sector-1 quasiparticles: the energies within 1e-8 of the JAX
    package's; for the U(1) vacuum also of the exact single-particle modes
    h - 2 cos(n pi / (L+1)); the B tensors exactly on the flux mask."""
    Hj, sj = _finite_groundstate(model)
    ej, _ = jexcitations(Hj, JQPA(tol=1e-10), sj, sector=1, num=3)
    Ht = (xx_chain_with_field(h=4.0) if model == "xx"
          else transverse_field_ising_parity(g=4.0))
    st = _carry_finite(sj)
    et, qps = excitations(Ht, QuasiparticleAnsatz(tol=1e-10), st, sector=1,
                          num=3, generator=torch.Generator().manual_seed(0))
    assert et.device.type == "cpu" and et.shape == (3,)
    np.testing.assert_allclose(np.sort(et.numpy()),
                               np.sort(np.real(np.asarray(ej))), rtol=0,
                               atol=1e-8)
    if model == "xx":
        ks = np.pi * np.arange(1, 9) / 9
        np.testing.assert_allclose(np.sort(et.numpy()),
                                   np.sort(4.0 - 2 * np.cos(ks))[:3],
                                   rtol=0, atol=1e-8)
    off = ~torch.as_tensor(st.flux_masks(1))
    for qp in qps:
        B = qp.bs()
        assert float((B * off).abs().max()) <= 1e-10 * float(B.abs().max())


def test_infinite_charged_excitation_matches_jax():
    """An infinite Z_2 state: the parity TFIM g=1.5 on a one-site cell at
    D=12 (the JAX package's sector VUMPS ground state, carried across).
    The sector-1 quasiparticle at p=0 (the single flip): within 1e-8 of
    the JAX package's first sector-1 level and 1e-6 of the exact gap
    2|g - 1| = 1, with B exactly on the flux mask, and the next sector-1
    level above it. The JAX package's sector solve does not lift the
    sector's complement, whose eigenvalue 0 under P H P lies below the
    gap: its second level here is that 0 (pinned, a reference-side
    defect)."""
    Hj = jham.transverse_field_ising_parity(g=1.5, dtype=np.float64)
    sj = jch.SymmetricInfiniteMPS.random(jax.random.PRNGKey(0), 1, (0, 1), 12,
                                         dtype=jnp.float64, modulus=2)
    sj, _, _ = jch.find_groundstate_symmetric_infinite(
        sj, Hj, JVUMPS(tol=1e-10, maxiter=100))
    ej, _ = jexcitations(Hj, JQPA(tol=1e-10), 0.0, sj, sector=1, num=2)
    p = sj.state
    st = symmetric_infinite_mps_from_numpy(
        *(np.asarray(x) for x in (p.AL, p.AR, p.AC, p.C)), sj.bond_charges,
        sj.phys_charges, sj.modulus, device="cpu")
    et, qps = excitations(transverse_field_ising_parity(g=1.5),
                          QuasiparticleAnsatz(tol=1e-10), 0.0, st, sector=1,
                          num=2, generator=torch.Generator().manual_seed(0))
    assert et.shape == (1, 2)
    assert abs(float(et[0, 0]) - float(np.real(np.asarray(ej)[0, 0]))) < 1e-8
    assert abs(float(et[0, 0]) - 1.0) < 1e-6 and float(et[0, 1]) > 1.0
    assert abs(float(np.real(np.asarray(ej)[0, 1]))) < 1e-8
    off = ~torch.as_tensor(st.flux_masks(1))
    for qp in qps[0]:
        B = qp.bs()
        assert float((B * off).abs().max()) <= 1e-10 * float(B.abs().max())


def test_sector_requires_a_symmetric_state():
    """sector= on a plain FiniteMPS or InfiniteMPS raises TypeError, as in
    the JAX package."""
    H = transverse_field_ising_parity(g=2.0)
    gen = torch.Generator().manual_seed(3)
    psi = FiniteMPS.random(6, 2, 4, torch.float64, "cpu", gen)
    with pytest.raises(TypeError, match="SymmetricFiniteMPS"):
        excitations(H, QuasiparticleAnsatz(), psi, sector=1)
    ipsi = InfiniteMPS.random(1, 2, 4, torch.float64, "cpu", gen)
    with pytest.raises(TypeError, match="SymmetricInfiniteMPS"):
        excitations(H, QuasiparticleAnsatz(), 0.0, ipsi, sector=1)
