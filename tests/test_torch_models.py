"""The models and the MPOHamiltonian algebra of the PyTorch port against the
JAX package and against dense exact diagonalization, on the CPU.

Both packages build their FSM arrays on the host in numpy from the same
parameters, so the model tensors and the algebra are compared exactly
(tolerance 0). Energies from the MPOs are compared with dense spectra to
1e-10 (float64 eigvalsh of matrices up to 256 x 256), and the
Jordan-Wigner convention of the fermion models is pinned by a string
correlator of the exact free-fermion ground state."""

import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import toolbox as jtb
from mpskit_tpu.models import fermions as jf
from mpskit_tpu.models import hamiltonians as jh
from mpskit_tpu.models import statmech as jsm
from mpskit_tpu.operators.mpo import DenseMPO as JDenseMPO
from mpskit_tpu.operators.mpo import MPOHamiltonian as JMPOHamiltonian
from mpskit_tpu_torch import (
    FiniteMPS, MPOHamiltonian, periodic_boundary_conditions,
    periodic_boundary_conditions_densempo, string_correlator,
)
from mpskit_tpu_torch.interop import dense_mpo_from_numpy
from mpskit_tpu_torch.models import fermions as tf
from mpskit_tpu_torch.models import hamiltonians as th
from mpskit_tpu_torch.models import statmech as tsm

torch.set_num_threads(1)

_MODELS = [
    ("transverse_field_ising_parity", dict(g=0.7, period=2)),
    ("xx_chain_with_field", dict(h=0.3)),
    ("heisenberg_XXZ", dict(spin=0.5, delta=0.6)),
    ("heisenberg_XXZ", dict(spin=1, delta=1.3, period=2)),
    ("heisenberg_XYZ", dict(Jx=0.5, Jy=1.5, Jz=-0.7)),
    ("heisenberg_XYZ", dict(spin=1, dtype=np.float64)),
    ("bilinear_biquadratic_model", dict(theta=0.3)),
    ("xy_model", dict(gamma=0.4, g=1.2)),
    ("quantum_potts", dict(q=3, g=0.8)),
    ("quantum_clock", dict(q=5, g=1.1)),
    ("bose_hubbard", dict(t=0.7, U=2.0, mu=0.3, n_max=2)),
    ("heisenberg_XXX", dict(spin=1.5)),
    ("transverse_field_ising", dict(g=0.9, period=3)),
]
_FERMIONS = [
    ("kitaev_chain", dict(t=1.0, mu=0.4, delta=0.6)),
    ("free_fermions", dict(t=0.8, mu=-0.2, period=2)),
    ("hubbard", dict(t=1.0, U=4.0, mu=2.0, period=2)),
    ("hubbard", dict(t=0.5, U=1.0, mu=0.1, dtype=np.complex128)),
]


def _same(jH, tH):
    """Tolerance 0: the same array, metadata and auxiliary charges."""
    W = np.asarray(jH.W)
    assert W.shape == tH.W.shape and W.dtype == tH.W.dtype
    assert np.array_equal(W, tH.W)
    assert jH.nonzero_mask == tH.nonzero_mask
    assert jH.diag_class == tH.diag_class
    assert jH.diag_scalar == tH.diag_scalar
    assert jH.aux_charges == tH.aux_charges


@pytest.mark.parametrize("name,kw", _MODELS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(_MODELS)])
def test_spin_models_equal_the_jax_ones(name, kw):
    _same(getattr(jh, name)(**kw), getattr(th, name)(**kw))


@pytest.mark.parametrize("name,kw", _FERMIONS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(_FERMIONS)])
def test_fermion_models_equal_the_jax_ones(name, kw):
    _same(getattr(jf, name)(**kw), getattr(tf, name)(**kw))
    assert tf.kitaev_bdg_energy(7, 1.0, 0.3, 0.5) == \
        jf.kitaev_bdg_energy(7, 1.0, 0.3, 0.5)


_ALGEBRA = {
    "matmul": lambda H: H @ H,
    "matmul_other": lambda H: H @ (H * 0.5 + 0.25),
    "sub": lambda H: H - H * 2.0,
    "sub_scalar": lambda H: H - 0.3,
    "repeat": lambda H: H.repeat(3),
    "conj": lambda H: H.conj(),
    "remove_orphans": lambda H: (H @ H).remove_orphans(),
    "add_physical_charge": lambda H: H.add_physical_charge([0, 1, 1]),
}


@pytest.mark.parametrize("op", list(_ALGEBRA))
def test_mpo_algebra_equals_jax(op):
    """Every operation on the complex XXZ FSM (and a period-2 cell for
    the cell-growing ones) gives the JAX package's array, to 0."""
    for kw in (dict(spin=0.5, delta=0.7), dict(spin=1, delta=0.3,
                                               period=2)):
        _same(_ALGEBRA[op](jh.heisenberg_XXZ(**kw)),
              _ALGEBRA[op](th.heisenberg_XXZ(**kw)))


def test_from_fsm_and_the_algebra_act_as_operators():
    """from_fsm equals JAX's to 0; as dense matrices on L=5, H1 @ H2 is the
    matrix product, H1 - H2 the difference, conj the adjoint, and
    remove_orphans leaves the matrix unchanged while it drops the dead
    levels (to 1e-12)."""
    X = np.array([[0, 1], [1, 0.0]])
    Z = np.diag([1.0, -1.0])
    entries = {(0, 0, 0): 1.0, (0, 2, 2): 1.0, (0, 0, 1): -X, (0, 1, 2): X,
               (0, 0, 2): -0.4 * Z, (1, 0, 0): 1.0, (1, 2, 2): 1.0,
               (1, 0, 1): 0.3j * Z, (1, 1, 2): Z}
    jH = JMPOHamiltonian.from_fsm(entries, 3, 2, period=2)
    tH = MPOHamiltonian.from_fsm(entries, 3, 2, period=2)
    _same(jH, tH)
    H2 = th.heisenberg_XXZ(spin=0.5, delta=0.3, period=2)
    L = 5
    M1, M2 = tH.to_matrix(L), H2.to_matrix(L)
    np.testing.assert_allclose((tH @ H2).to_matrix(L), M1 @ M2, atol=1e-12)
    np.testing.assert_allclose((tH - H2).to_matrix(L), M1 - M2, atol=1e-12)
    np.testing.assert_allclose(tH.conj().to_matrix(L), M1.conj().T,
                               atol=1e-12)
    HH = H2 @ H2
    pruned = HH.remove_orphans()
    assert pruned.odim < HH.odim
    np.testing.assert_allclose(pruned.to_matrix(L), HH.to_matrix(L),
                               atol=1e-12)
    charged = H2.add_physical_charge([1, 0, 2])
    assert charged.period == 6 and charged.aux_charges == (1, 0, 2, 1, 0, 2)
    np.testing.assert_array_equal(charged.W, np.tile(H2.W, (3, 1, 1, 1, 1)))


def _ring_matrix(h2, h1, L):
    """Dense sum over a ring of L sites of a two-site term h2 (d^2 x d^2)
    on (i, i+1 mod L) and a one-site term h1."""
    d = h1.shape[0]
    eye = np.eye(d)
    H = np.zeros((d ** L, d ** L), np.result_type(h2, h1))
    for i in range(L):
        ops = [eye] * L
        ops[i] = h1
        term = ops[0]
        for o in ops[1:]:
            term = np.kron(term, o)
        H += term
    T = h2.reshape(d, d, d, d)
    for i in range(L):
        j = (i + 1) % L
        # apply T on sites (i, j) of the full tensor
        full = np.zeros((d,) * (2 * L), H.dtype)
        idx = np.indices((d,) * L).reshape(L, -1).T
        for s in idx:
            for t1 in range(d):
                for t2 in range(d):
                    t = s.copy()
                    t[i], t[j] = t1, t2
                    full[tuple(s) + tuple(t)] += T[s[i], s[j], t1, t2]
        H += full.reshape(d ** L, d ** L)
    return H


@pytest.mark.parametrize("model", ["tfim", "xxz_period2"])
def test_periodic_boundary_conditions(model):
    """The ring FSM equals JAX's to 0, and its lowest eigenvalues on L=8
    equal those of the dense ring to 1e-10."""
    L = 8
    X, _, Z, I = (np.asarray(m) for m in th.pauli(np.float64))
    if model == "tfim":
        jH, tH = jh.transverse_field_ising_lattice(g=0.8,
                                                   dtype=np.float64), \
            th.transverse_field_ising_lattice(g=0.8, dtype=np.float64)
        h2, h1 = -np.kron(Z, Z), -0.8 * X
    else:
        jH, tH = (m.heisenberg_XXZ(spin=0.5, delta=0.6, period=2)
                  for m in (jh, th))
        Sx, Sy, Sz, _ = th.spinmatrices(0.5)
        h2 = 4 * (np.kron(Sx, Sx) + np.kron(Sy, Sy) + 0.6 * np.kron(Sz, Sz))
        h1 = np.zeros((2, 2))
    jP = jtb.periodic_boundary_conditions(jH, L)
    tP = periodic_boundary_conditions(tH, L)
    _same(jP, tP)
    ev = np.linalg.eigvalsh(tP.to_matrix(L))[:4]
    ev_ring = np.linalg.eigvalsh(_ring_matrix(h2, h1, L))[:4]
    np.testing.assert_allclose(ev, ev_ring, rtol=0, atol=1e-10)


def test_periodic_boundary_conditions_densempo():
    """The open-chain DenseMPO equals JAX's to 0, and its dense matrix is
    the ring trace of the classical Ising row's matrices on L=5 (1e-12)."""
    L = 5
    jO = jtb.periodic_boundary_conditions_densempo(jsm.classical_ising(), L)
    tO = periodic_boundary_conditions_densempo(tsm.classical_ising(), L)
    assert len(jO.Os) == len(tO.Os) == L
    for a, b in zip(jO.Os, tO.Os):
        assert np.array_equal(np.asarray(a), b)
    O = tsm.classical_ising().site(0)
    d = O.shape[2]

    def dense(sites, ring):
        E = np.eye(O.shape[0])[:, None, None, :] if ring else \
            np.ones((1, 1, 1, 1))
        # E[alpha, S, T, b]
        for o in sites:
            a, S, T, _ = E.shape
            E = np.einsum("aSTb,bcst->aSsTtc", E, o).reshape(
                a, S * d, T * d, o.shape[1])
        return np.einsum("aSTa->ST", E) if ring else E[0, :, :, 0]

    np.testing.assert_allclose(dense(tO.Os, False), dense([O] * L, True),
                               atol=1e-12)


def _ground_vector(H, L):
    w, v = np.linalg.eigh(H.to_matrix(L))
    return w[0], v[:, 0]


@pytest.mark.parametrize("model", ["kitaev", "free", "hubbard_dimer"])
def test_fermion_ground_energies(model):
    """The MPO's lowest eigenvalue equals the Bogoliubov-de-Gennes energy
    (Kitaev chain, free fermions, L=8) or the exact Hubbard dimer's
    (two sites, U=4, 16 states, diagonalized in the occupation basis
    with the hops written out by hand), to 1e-10."""
    if model == "kitaev":
        e, _ = _ground_vector(tf.kitaev_chain(t=1.0, mu=0.4, delta=0.6), 8)
        assert abs(e - tf.kitaev_bdg_energy(8, 1.0, 0.4, 0.6)) <= 1e-10
    elif model == "free":
        e, _ = _ground_vector(tf.free_fermions(t=1.0, mu=0.3), 8)
        assert abs(e - tf.kitaev_bdg_energy(8, 1.0, 0.3, 0.0)) <= 1e-10
    else:
        U, mu = 4.0, 2.0
        H = tf.hubbard(t=1.0, U=U, mu=mu)
        # four modes (1up, 1dn, 2up, 2dn), JW order; hops 1s <-> 2s
        modes = 4

        def c(k):
            """Annihilator of mode k on the 2^4 Fock space (JW signs)."""
            a = np.array([[0, 1], [0, 0.0]])
            z = np.diag([1.0, -1.0])
            ops = [z] * k + [a] + [np.eye(2)] * (modes - k - 1)
            out = ops[0]
            for o in ops[1:]:
                out = np.kron(out, o)
            return out

        cs = [c(k) for k in range(modes)]
        n = [ck.T @ ck for ck in cs]
        Hd = sum(-(cs[a].T @ cs[b] + cs[b].T @ cs[a])
                 for a, b in ((0, 2), (1, 3)))
        Hd = Hd + U * (n[0] @ n[1] + n[2] @ n[3]) - mu * sum(n)
        np.testing.assert_allclose(np.linalg.eigvalsh(H.to_matrix(2)),
                                   np.linalg.eigvalsh(Hd), atol=1e-10)


def test_jordan_wigner_string_correlator_is_the_fermion_bilinear():
    """<c_i^dag c_j> of the exact free-fermion ground state at L=8 (from
    the filled modes of the hopping matrix) equals string_correlator(psi,
    c^dag Z, Z, c, i, j) of the dense ground vector of the JW MPO, made a
    FiniteMPS by from_dense, to 1e-10 for every i < j; at (2, 5) both are
    -1/6."""
    L = 8
    H = tf.free_fermions(t=1.0, mu=0.0)
    _, v = _ground_vector(H, L)
    psi = FiniteMPS.from_dense(v, 2, 16, device="cpu")
    h = -(np.eye(L, k=1) + np.eye(L, k=-1))
    e, U = np.linalg.eigh(h)
    occ = U[:, e < 0]
    C = occ @ occ.T
    c = np.array([[0, 1], [0, 0.0]])
    Z = np.diag([1.0, -1.0])
    for i in range(L - 1):
        js = list(range(i + 1, L))
        got = string_correlator(psi, c.T @ Z, Z, c, i, js).numpy()
        np.testing.assert_allclose(got, C[i, js], rtol=0, atol=1e-10)
    assert abs(C[2, 5] + 1 / 6) <= 1e-12
