"""The reference-name surface and the plotting data of the PyTorch port
against the JAX package on the CPU: TransferMatrix (both directions, MPO
middle, products), the `environments` dispatcher with leftenv / rightenv
(finite, infinite Hamiltonian, DenseMPO), the dimension accessors,
add_util_leg, effective_excitation_hamiltonian, and the entanglement and
transfer plot data (plain and sector-resolved) with their renderings."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpskit_tpu as jm
from mpskit_tpu.states.quasiparticle import LeftGaugedQP as JLeftGaugedQP
from mpskit_tpu.symmetry import charges as jch
from mpskit_tpu.utils import plotting as jplot
import mpskit_tpu_torch as tm
from mpskit_tpu_torch.interop import (
    finite_mps_from_numpy, infinite_mps_from_numpy, left_gauged_qp_from_numpy,
    symmetric_finite_mps_from_numpy, symmetric_infinite_mps_from_numpy,
)
from mpskit_tpu_torch.utils import plotting as tplot

torch.set_num_threads(1)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def _np(t):
    return t.resolve_conj().numpy()


def _finite():
    pj = jm.FiniteMPS.random(jax.random.PRNGKey(0), 6, 2, 6,
                             dtype=jnp.complex128).move_center(2)
    pt = finite_mps_from_numpy(*(np.asarray(x) for x in
                                 (pj.ALs, pj.ARs, pj.AC)), pj.center,
                               device="cpu")
    return pj, pt


def _infinite(L=2, D=5, seed=1):
    pj = jm.InfiniteMPS.random(jax.random.PRNGKey(seed), L, 2, D,
                               dtype=jnp.complex128)
    pt = infinite_mps_from_numpy(*(np.asarray(x) for x in
                                   (pj.AL, pj.AR, pj.AC, pj.C)),
                                 device="cpu")
    return pj, pt


@pytest.mark.parametrize("flipped", [False, True])
@pytest.mark.parametrize("with_mpo", [False, True])
def test_transfer_matrix(flipped, with_mpo):
    """A single-site and a stacked (product) TransferMatrix, with and
    without an MPO middle, in both directions, applied to the same
    environment-shaped tensor as the JAX package's (1e-12)."""
    pj, pt = _infinite()
    H = jm.models.transverse_field_ising(g=1.2)
    Wj = jnp.stack([H.site(i) for i in range(2)]) if with_mpo else None
    Wt = torch.from_numpy(np.asarray(Wj)) if with_mpo else None
    rng = np.random.default_rng(0)
    shape = (Wj.shape[1], 5, 5) if with_mpo else (5, 5)
    v = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    Tj = jm.TransferMatrix(pj.AL[0], pj.AR[0],
                           None if Wj is None else Wj[0], flipped)
    Tt = tm.TransferMatrix(pt.AL[0], pt.AR[0],
                           None if Wt is None else Wt[0], flipped)
    _close(_np(Tt(torch.from_numpy(v))), Tj(jnp.asarray(v)), 1e-12)
    Pj = Tj * jm.TransferMatrix(pj.AL[1], pj.AL[1],
                                None if Wj is None else Wj[1], flipped)
    Pt = Tt * tm.TransferMatrix(pt.AL[1], pt.AL[1],
                                None if Wt is None else Wt[1], flipped)
    _close(_np(Pt(torch.from_numpy(v))), Pj(jnp.asarray(v)), 1e-12)
    assert Tt.flip().flipped is not flipped
    if not with_mpo:
        _close(_np(tm.TransferMatrix(pt.AL, pt.AL)(torch.from_numpy(v))),
               _np(tm.transfer_left(tm.transfer_left(
                   torch.from_numpy(v), pt.AL[0], pt.AL[0]),
                   pt.AL[1], pt.AL[1])), 1e-13)


def test_environments_dispatch():
    """environments() gives the finite, infinite-Hamiltonian and DenseMPO
    environments; leftenv / rightenv equal the JAX package's (1e-10), and a
    pair it does not know raises TypeError."""
    pj, pt = _finite()
    Hj = jm.models.transverse_field_ising(g=1.2)
    Ht = tm.transverse_field_ising(g=1.2)
    ej, et = jm.environments(pj, Hj), tm.environments(pt, Ht)
    for i in range(6):
        _close(_np(tm.leftenv(et, i, pt)), jm.leftenv(ej, i, pj), 1e-10)
        _close(_np(tm.rightenv(et, i)), jm.rightenv(ej, i), 1e-10)
    ij, it = _infinite()
    ej, et = jm.environments(ij, Hj), tm.environments(it, Ht)
    assert abs(complex(et.e_density) - complex(ej.e_density)) < 1e-10
    for i in range(2):
        _close(_np(tm.leftenv(et, i)), jm.leftenv(ej, i), 1e-8)
        _close(_np(tm.rightenv(et, i)), jm.rightenv(ej, i), 1e-8)
    Oj = jm.models.classical_ising()
    Ot = tm.classical_ising()
    bj = jm.InfiniteMPS.random(jax.random.PRNGKey(4), 1, 2, 4,
                               dtype=jnp.complex128)
    bt = infinite_mps_from_numpy(*(np.asarray(x) for x in
                                   (bj.AL, bj.AR, bj.AC, bj.C)), device="cpu")
    mj, mt = jm.environments(bj, Oj), tm.environments(bt, Ot)
    assert type(mt).__name__ == "InfiniteMPOEnv"
    lj, lt = np.asarray(jm.leftenv(mj, 0)), _np(tm.leftenv(mt, 0))
    # dominant eigenvectors: equal up to a scalar
    c = np.vdot(lt.reshape(-1), lj.reshape(-1)) / np.vdot(lt.reshape(-1),
                                                         lt.reshape(-1))
    _close(c * lt, lj, 1e-8 * np.abs(lj).max())
    with pytest.raises(TypeError):
        tm.environments(it, object())


def test_accessors_and_util_leg():
    """max_Ds, left / right virtual spaces and physicalspace equal the JAX
    package's (finite and infinite); add_util_leg gives (1, 1, d, d)."""
    pj, pt = _finite()
    assert np.array_equal(tm.max_Ds(pt), jm.max_Ds(pj))
    for i in range(6):
        assert tm.left_virtualspace(pt, i) == jm.left_virtualspace(pj, i)
        assert tm.right_virtualspace(pt, i) == jm.right_virtualspace(pj, i)
        assert tm.physicalspace(pt, i) == jm.physicalspace(pj, i) == 2
    ij, it = _infinite()
    assert tm.left_virtualspace(it) == jm.left_virtualspace(ij) == 5
    assert tm.right_virtualspace(it, 1) == jm.right_virtualspace(ij, 1)
    op = np.array([[0.0, 1.0], [1.0, 0.0]])
    W = tm.add_util_leg(op)
    assert W.shape == (1, 1, 2, 2) and np.array_equal(W.numpy()[0, 0], op)
    _close(W.numpy(), jm.add_util_leg(op), 0)
    with pytest.raises(ValueError):
        tm.add_util_leg(np.ones(3))
    assert tm.SparseMPO is tm.MPOHamiltonian
    assert isinstance(tm.LeftGaugedQP.random(
        it, generator=torch.Generator().manual_seed(0)), tm.QP)
    assert tm.MPSTensor is torch.Tensor


def test_effective_excitation_hamiltonian():
    """(H_eff - E) on a LeftGaugedQP (the JAX QP's X blocks and null spaces
    carried across) equals the JAX package's (1e-8), at momentum 0.7."""
    ij, it = _infinite(L=1, D=4, seed=2)
    Hj = jm.models.transverse_field_ising(g=1.5)
    Ht = tm.transverse_field_ising(g=1.5)
    qj = JLeftGaugedQP.random(jax.random.PRNGKey(5), ij, momentum=0.7)
    qt = left_gauged_qp_from_numpy(np.asarray(qj.Xs), np.asarray(qj.VLs), it,
                                   0.7)
    yj = jm.effective_excitation_hamiltonian(Hj, qj)
    yt = tm.effective_excitation_hamiltonian(Ht, qt)
    _close(_np(yt.Xs), yj.Xs, 1e-8)


def test_plot_data_and_rendering():
    """entanglement_plot_data and transfer_plot_data equal the JAX
    package's (1e-10); the sector data of a SymmetricFiniteMPS and a
    SymmetricInfiniteMPS equal its per sector and union to the plain
    spectrum; the plots render headless with one series per sector."""
    import matplotlib
    matplotlib.use("Agg")
    pj, pt = _finite()
    _close(tplot.entanglement_plot_data(pt, 3),
           jplot.entanglement_plot_data(pj, 3), 1e-10)
    ij, it = _infinite()
    tj, rj = jplot.transfer_plot_data(ij, num=4)
    tt, rt = tplot.transfer_plot_data(it, num=4)
    _close(np.sort(rt), np.sort(rj), 1e-10)
    assert tplot.entanglement_plot_data_sectors(pt, 3).keys() == {None}
    sj = jch.SymmetricFiniteMPS.random(jax.random.PRNGKey(3), 6, (1, -1), 8,
                                       dtype=jnp.float64)
    p = sj.state
    st = symmetric_finite_mps_from_numpy(
        *(np.asarray(x) for x in (p.ALs, p.ARs, p.AC)), p.center,
        sj.bond_charges, sj.phys_charges, device="cpu")
    sij = jch.SymmetricInfiniteMPS.random(jax.random.PRNGKey(3), 2, [1, -1],
                                          10, dtype=jnp.float64)
    q = sij.state
    sit = symmetric_infinite_mps_from_numpy(
        *(np.asarray(x) for x in (q.AL, q.AR, q.AC, q.C)), sij.bond_charges,
        sij.phys_charges, device="cpu")
    for a, b, plain in ((sj, st, tm.entanglement_spectrum(st.state, 3)),
                        (sij, sit, None)):
        dj = jplot.entanglement_plot_data_sectors(a)
        dt = tplot.entanglement_plot_data_sectors(b)
        assert sorted(dj) == sorted(dt) and len(dt) >= 2
        for k in dj:
            _close(np.sort(dt[k]), np.sort(np.asarray(dj[k])), 1e-10)
        if plain is not None:
            allv = np.sort(np.concatenate(list(dt.values())))
            s = np.sort(plain.numpy())
            _close(allv, s[s > 1e-14], 1e-10)
    assert len(tm.entanglement_plot(pt, 3).lines) == 1
    assert len(tm.transferplot(it, 4).lines) == 1
    ax = tplot.entanglement_plot_sectors(sit)
    assert len(ax.lines) == len(tplot.entanglement_plot_data_sectors(sit))
    with pytest.raises(NotImplementedError, match="item 11"):
        tplot.entanglement_plot_data_sectors(type("SU2ReducedState", (),
                                                  {})())
