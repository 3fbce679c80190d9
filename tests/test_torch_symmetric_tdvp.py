"""Symmetric time evolution and sector-aware bond expansion of the
PyTorch port against the JAX package on the CPU: finite (U(1) in two
sectors and Z_2) and infinite symmetric `timestep` over two steps in
complex128, `expand_symmetric_finite`, `expand_symmetric_infinite`
(OptimalExpand and RandExpand) and `changebonds_symmetric`. The states
are the JAX package's, carried across with `interop`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import expectation_value as jexpval
from mpskit_tpu.algorithms.changebonds import OptimalExpand as JOptimal
from mpskit_tpu.algorithms.changebonds import RandExpand as JRand
from mpskit_tpu.algorithms.tdvp import TDVP as JTDVP
from mpskit_tpu.algorithms.tdvp import timestep as jtimestep
from mpskit_tpu.models import hamiltonians as jham
from mpskit_tpu.symmetry import charges as jch
from mpskit_tpu.symmetry import expand as jexp
from mpskit_tpu_torch import (
    TDVP, OptimalExpand, RandExpand, expectation_value, heisenberg_XXX,
    heisenberg_XXZ, timestep, transverse_field_ising_parity,
)
from mpskit_tpu_torch.interop import (
    symmetric_finite_mps_from_numpy, symmetric_infinite_mps_from_numpy,
)
from mpskit_tpu_torch.symmetry import expand as texp

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


def _dense(psi):
    """The finite state's vector (host numpy)."""
    p = psi.move_center(0)
    v = np.asarray(p.AC)[:1]
    for i in range(1, p.length):
        v = np.einsum("...m,mpr->...pr", v, np.asarray(p.ARs[i]))
    return v[..., :1].reshape(-1)


def _models(case):
    if case == "z2":
        return (jham.transverse_field_ising_parity(g=1.5),
                transverse_field_ising_parity(g=1.5,
                                              dtype=np.complex128),
                (0, 1), 0, 2)
    total = 0 if case == "u1" else 2
    return (jham.heisenberg_XXZ(spin=0.5, delta=0.5),
            heisenberg_XXZ(spin=0.5, delta=0.5), (1, -1), total, None)


@pytest.mark.parametrize("case", ["u1", "u1_charged", "z2"])
def test_symmetric_finite_timestep_matches_jax(case):
    """Two steps of dt=0.05 of a random L=8 D=8 sector state under XXZ
    (delta=0.5; Sz_tot 0 and 1) or the parity TFIM (Z_2): the same state
    as the JAX package's to 1e-10 (1 - |overlap|, energy), the charge
    conserved to 1e-12 and every tensor exactly zero outside the mask."""
    Hj, Ht, phys, total, modulus = _models(case)
    sj = jch.SymmetricFiniteMPS.random(jax.random.PRNGKey(1), 8, phys, 8,
                                       total=total, dtype=jnp.complex128,
                                       modulus=modulus)
    st = _carry_finite(sj)
    for k in range(2):
        sj, _ = jtimestep(sj, Hj, 0.05 * k, 0.05, JTDVP())
        st, envs = timestep(st, Ht, 0.05 * k, 0.05, TDVP())
    assert envs is None and st.modulus == modulus
    vj = _dense(sj.state)
    vt = _dense(type(sj.state)(*(jnp.asarray(x.numpy()) for x in (
        st.state.ALs, st.state.ARs, st.state.AC)), 0))
    assert 1 - abs(np.vdot(vj, vt)) / (np.linalg.norm(vj)
                                       * np.linalg.norm(vt)) < 1e-10
    Ej = complex(jexpval(sj.state, Hj)).real
    Et = complex(expectation_value(st.state, Ht)).real
    assert abs(Et - Ej) < 1e-10
    m = st.masks
    assert _leak(st.state.AC, m[0]) == 0
    assert _leak(st.state.ARs[1:], m[1:]) == 0
    if modulus is None:
        sz = sum(complex(expectation_value(st.state, (i, SZ))).real
                 for i in range(8))
        assert abs(sz - total / 2) < 1e-12


def test_symmetric_infinite_timestep_matches_jax():
    """Two infinite TDVP steps (dt=0.05, XXZ delta=0.5) of a random
    two-site sector state (D=6, complex128): AC and C equal to the JAX
    package's to 1e-10 and exactly zero outside their masks; the returned
    environments warm-start the second step."""
    Hj = jham.heisenberg_XXZ(spin=0.5, delta=0.5)
    Ht = heisenberg_XXZ(spin=0.5, delta=0.5)
    sj = jch.SymmetricInfiniteMPS.random(jax.random.PRNGKey(2), 2, [1, -1],
                                         6, dtype=jnp.complex128)
    st = _carry_infinite(sj)
    envsj = envst = None
    for k in range(2):
        sj, envsj = jtimestep(sj, Hj, 0.05 * k, 0.05, JTDVP(), envs=envsj)
        st, envst = timestep(st, Ht, 0.05 * k, 0.05, TDVP(), envs=envst)
    for f in ("AC", "C"):
        np.testing.assert_allclose(getattr(st.state, f).numpy(),
                                   np.asarray(getattr(sj.state, f)),
                                   rtol=0, atol=1e-10)
    A_mask, C_mask = st.masks
    assert _leak(st.state.AC, A_mask) == 0 == _leak(st.state.C, C_mask)
    assert _leak(st.state.AL, A_mask) == 0 == _leak(st.state.AR, A_mask)


def test_expand_symmetric_finite_matches_jax():
    """Grow every bond of an L=8 D=8 sector state by 4 slots: the same new
    labels as the JAX package's, the same (unchanged) energy to 1e-12,
    zero leakage, then a symmetric TDVP step conserving Sz_tot."""
    sj = jch.SymmetricFiniteMPS.random(jax.random.PRNGKey(5), 8, [1, -1], 8,
                                       total=0, dtype=jnp.complex128)
    st = _carry_finite(sj)
    bj = jexp.expand_symmetric_finite(sj, 4)
    bt = texp.expand_symmetric_finite(st, 4)
    assert bt.state.D == 12
    for a, b in zip(bj.bond_charges, bt.bond_charges):
        assert np.array_equal(a, b)
    H = heisenberg_XXX(spin=0.5)
    E0 = complex(expectation_value(st.state, H)).real
    assert abs(complex(expectation_value(bt.state, H)).real - E0) < 1e-12
    assert _leak(bt.state.ARs[1:], bt.masks[1:]) == 0
    out, _ = timestep(bt, heisenberg_XXZ(spin=0.5, delta=0.5), 0.0, 0.05)
    sz = sum(complex(expectation_value(out.state, (i, SZ))).real
             for i in range(8))
    assert abs(sz) < 1e-12 and _leak(out.state.AC, out.masks[0]) == 0


@pytest.mark.parametrize("optimal", [True, False])
def test_expand_symmetric_infinite_matches_jax(optimal):
    """OptimalExpand (the per-sector SVDs of the two-site residual) and
    RandExpand of a random two-site XXX sector state, D=6 + 3, through
    changebonds_symmetric: labels extended, not overwritten, equal to the
    JAX package's; the expanded state exactly on its masks. The noise on
    the new block comes from another generator, so the energies agree to
    the noise's 1e-6 only."""
    Hj = jham.heisenberg_XXX(spin=0.5)
    Ht = heisenberg_XXX(spin=0.5)
    sj = jch.SymmetricInfiniteMPS.random(jax.random.PRNGKey(6), 2, [1, -1],
                                         6, dtype=jnp.complex128)
    st = _carry_infinite(sj)
    if optimal:
        bj = jexp.changebonds_symmetric(sj, Hj, alg=JOptimal(dims=3))
        bt = texp.changebonds_symmetric(st, Ht, alg=OptimalExpand(dims=3))
    else:
        bj = jexp.changebonds_symmetric(sj, alg=JRand(dims=3))
        bt = texp.changebonds_symmetric(st, alg=RandExpand(dims=3))
    assert bt.state.D == 9
    for a, b, old in zip(bj.bond_charges, bt.bond_charges, st.bond_charges):
        assert np.array_equal(a, b) and np.array_equal(b[:6], old)
    A_mask, C_mask = bt.masks
    assert _leak(bt.state.AL, A_mask) == 0 == _leak(bt.state.C, C_mask)
    ej = np.mean(np.asarray(jexpval(bj.state, Hj)).real)
    et = float(expectation_value(bt.state, Ht).real.mean())
    assert abs(et - ej) < 1e-5
    with pytest.raises(TypeError):
        texp.changebonds_symmetric(st, Ht, alg=object())
