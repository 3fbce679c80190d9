"""The SU(2)-reduced finite MPS of the PyTorch port against the JAX package
on the CPU, float64 (complex128 for real-time TDVP): the finite bond
structure, the two-site compose / split and effective Hamiltonian, and
the finite algorithm surface (DMRG, DMRG2 with dynamic multiplet
allocation, bond growth, TDVP and the dispatchers) on the spin-1
Heisenberg chain. The JAX states are drawn from PRNGKeys and carried
across with `interop.su2_finite_mps_from_numpy`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.symmetry import su2_finite as jf
from mpskit_tpu.symmetry import su2_reduced as jr
from mpskit_tpu_torch.interop import (
    rblocks_from_numpy, su2_finite_mps_from_numpy,
)
from mpskit_tpu_torch.symmetry import su2_finite as tf
from mpskit_tpu_torch.symmetry import su2_reduced as tr

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(3)
TJP = 2
MPO_J, MPO = jr.heisenberg_reduced(TJP), tr.heisenberg_reduced(TJP)


def _carry(rb):
    return rblocks_from_numpy(rb.keys, [np.asarray(v) for v in rb.vals],
                              device="cpu")


def _carry_psi(pj):
    return su2_finite_mps_from_numpy(
        [(s.keys, [np.asarray(v) for v in s.vals]) for s in pj.sites],
        pj.bonds, pj.center, pj.tjp, device="cpu")


def _same(t, j, tol):
    assert t.keys == tuple(j.keys)
    for k in t.keys:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=0,
                                   atol=tol)


def _dense_heisenberg(L, tjs=2):
    ss = tr._spin_ss(tjs)
    d = tjs + 1
    H = np.zeros((d ** L, d ** L))
    for i in range(L - 1):
        H += np.kron(np.kron(np.eye(d ** i), ss), np.eye(d ** (L - i - 2)))
    return H


@functools.lru_cache(maxsize=None)
def _e_exact(L):
    return float(np.linalg.eigvalsh(_dense_heisenberg(L))[0])


@pytest.mark.parametrize("L,target,max_mult", [(6, 0, 4), (7, 2, 3),
                                               (32, 0, 8)])
def test_finite_bonds_consistency(L, target, max_mult):
    """finite_bonds equals the JAX package's, and every multiplicity is
    reachable by fusing the neighbour bond."""
    bonds = tf.finite_bonds(L, TJP, target, max_mult)
    assert bonds == jf.finite_bonds(L, TJP, target, max_mult)
    for i in range(L):
        cap = dict(tf.fuse_sectors(bonds[i], TJP))
        assert all(m <= cap[tj] for tj, m in bonds[i + 1])
        cap2 = dict(tf.fuse_sectors(bonds[i + 1], TJP))
        assert all(m <= cap2[tj] for tj, m in bonds[i])


def _pair():
    secs_l, secs_m, secs_r = ((0, 2), (2, 3), (4, 1)), ((2, 4), (4, 2)), \
        ((0, 2), (2, 2))
    A1 = jf._random_site(KEY, secs_l, TJP, secs_m, jnp.float64)
    A2 = jf._random_site(jax.random.fold_in(KEY, 9), secs_m, TJP, secs_r,
                         jnp.float64)
    return secs_l, secs_r, A1, A2


def test_compose_theta_dense_parity():
    """compose_theta equals the JAX package's (1e-12) and the dense
    product of the embedded sites; restrict_theta inverts embed_theta."""
    secs_l, secs_r, A1j, A2j = _pair()
    th = tf.compose_theta(_carry(A1j), _carry(A2j), TJP)
    _same(th, jf.compose_theta(A1j, A2j, TJP), 1e-12)
    dense = tf.embed_theta(th, secs_l, TJP, secs_r)
    np.testing.assert_allclose(
        dense, jf.embed_theta(jf.compose_theta(A1j, A2j, TJP), secs_l, TJP,
                              secs_r), atol=1e-12)
    assert abs(np.linalg.norm(dense) - float(tr.tree_norm(th))) < 1e-12
    _same(tf.restrict_theta(dense, secs_l, TJP, secs_r, device="cpu"),
          jf.compose_theta(A1j, A2j, TJP), 1e-12)


@pytest.mark.parametrize("max_mult", [None, 2])
def test_split_theta_matches_jax(max_mult):
    """split_theta on the device: the same new bond, truncation error and
    bond matrix as the JAX package's host SVD (1e-12), an exact
    reconstruction without truncation, and dense-isometric factors."""
    secs_l, secs_r, A1j, A2j = _pair()
    thj = jf.compose_theta(A1j, A2j, TJP)
    th = _carry(thj)
    A1, C, A2, secs, err = tf.split_theta(th, TJP, max_mult=max_mult)
    A1j_, Cj, A2j_, secsj, errj = jf.split_theta(thj, TJP, max_mult=max_mult)
    assert secs == secsj and abs(err - errj) < 1e-12
    _same(C, Cj, 1e-12)
    if max_mult is None:
        assert err < 1e-12
        back = tf.compose_theta(A1, tr.rmul_c_left(C, A2), TJP, keys=th.keys)
        _same(back, thj, 1e-10)
    dA1 = tr.embed_site(A1, tr.SU2Bond(secs_l), TJP, tr.SU2Bond(secs))
    M = dA1.reshape(-1, dA1.shape[-1])
    np.testing.assert_allclose(M.T @ M, np.eye(M.shape[1]), atol=1e-10)


def test_rtheta_apply_matches_jax():
    """The two-site effective Hamiltonian on random environments equals
    the JAX package's (1e-12)."""
    secs_l, secs_r = ((0, 1), (2, 2), (4, 1)), ((0, 1), (2, 2))
    dl, dr = dict(secs_l), dict(secs_r)
    gls, grs = [], []
    for lvl, tk in enumerate(MPO_J.channels):
        for secs, d, out, base in ((secs_l, dl, gls, 100), (secs_r, dr, grs,
                                                          200)):
            ks = tuple((tb, tn) for tb in sorted(d) for tn in sorted(d)
                       if jr._admissible(tn, tk, tb))
            out.append(jr.RBlocks(ks, tuple(jax.random.normal(
                jax.random.fold_in(KEY, base + 10 * lvl + i),
                (d[k[0]], d[k[1]]), jnp.float64) for i, k in enumerate(ks))))
    keys = jf.theta_keys(secs_l, TJP, secs_r)
    thj = jr.RBlocks(keys, tuple(jax.random.normal(
        jax.random.fold_in(KEY, 300 + i), (dl[k[0]], dr[k[2]]), jnp.float64)
        for i, k in enumerate(keys)))
    out = tf.rtheta_apply([_carry(g) for g in gls], [_carry(g) for g in grs],
                          MPO, _carry(thj))
    _same(out, jf.rtheta_apply(tuple(gls), tuple(grs), MPO_J, thj), 1e-12)


@functools.lru_cache(maxsize=None)
def _dmrg2(L, max_mult0, max_mult, tol, maxiter, seed=0):
    pj = jf.SU2FiniteMPS.random(jax.random.fold_in(KEY, seed), L, TJP,
                                target_tj=0, max_mult=max_mult0)
    p = _carry_psi(pj)
    outj = jf.find_groundstate_su2_finite_dmrg2(
        pj, MPO_J, jf.SU2DMRG2(tol=tol, maxiter=maxiter, max_mult=max_mult))
    out = tf.find_groundstate_su2_finite_dmrg2(
        p, MPO, tf.SU2DMRG2(tol=tol, maxiter=maxiter, max_mult=max_mult))
    return out, outj


def test_dmrg2_spin1_heisenberg_vs_ed():
    """DMRG2 at L=6 from the same start: the same bond structure as the
    JAX package's, the energy within 1e-10 of its and 1e-8 of ED, and
    energy_reduced agreeing."""
    (psi, e, _), (pj, ej, _) = _dmrg2(6, 2, 12, 1e-11, 30)
    assert psi.bonds == pj.bonds
    assert abs(e - ej) < 1e-10 and abs(e - _e_exact(6)) < 1e-8
    assert abs(tf.energy_reduced(psi, MPO) - jf.energy_reduced(pj, MPO_J)) \
        < 1e-10
    for bond in (1, 3):
        s, sj = psi.schmidt(bond), pj.schmidt(bond)
        assert set(s) == set(sj)
        for k in s:
            np.testing.assert_allclose(s[k], sj[k], atol=1e-8)
        assert abs(psi.entropy(bond) - pj.entropy(bond)) < 1e-8


def test_dmrg_one_site_refines():
    """One-site DMRG continues the truncated DMRG2 state to ED, equal to
    the JAX package's continuation (1e-10)."""
    (psi, _, _), (pj, _, _) = _dmrg2(6, 2, 10, 1e-8, 8)
    psi, e, _ = tf.find_groundstate_su2_finite_dmrg(
        psi, MPO, tf.SU2DMRG(tol=1e-12, maxiter=20))
    _, ej, _ = jf.find_groundstate_su2_finite_dmrg(
        pj, MPO_J, jf.SU2DMRG(tol=1e-12, maxiter=20))
    assert abs(e - ej) < 1e-10 and abs(e - _e_exact(6)) < 1e-8


def test_expand_bond_grows_and_preserves_state():
    """expand_bond_reduced grows the bond as the JAX package does (the same
    new sectors), keeps the state, and one-site DMRG then lowers it."""
    (psi, _, _), (pj, _, _) = _dmrg2(6, 2, 2, 1e-8, 6)
    e_before = tf.energy_reduced(psi, MPO)
    psi2 = tf.expand_bond_reduced(psi, MPO, 3, extra_mult=2)
    pj2 = jf.expand_bond_reduced(pj, MPO_J, 3, extra_mult=2)
    assert psi2.bonds == pj2.bonds and psi2.center == pj2.center
    n0, n1 = (sum(m for _, m in p.bonds[3]) for p in (psi, psi2))
    assert n0 < n1 <= n0 + 2
    assert abs(tf.energy_reduced(psi2, MPO) - e_before) < 1e-10
    _, e3, _ = tf.find_groundstate_su2_finite_dmrg(
        psi2, MPO, tf.SU2DMRG(tol=1e-12, maxiter=15))
    assert e3 <= e_before + 1e-10


def test_tdvp_imaginary_time_lowers_energy():
    """Ten imaginary-time steps at L=4 from the same start: the energy
    equal to the JAX package's (1e-10), lowered, and above ED."""
    pj = jf.SU2FiniteMPS.random(KEY, 4, TJP, target_tj=0, max_mult=4)
    psi = _carry_psi(pj)
    e0 = tf.energy_reduced(psi, MPO)
    for _ in range(10):
        psi, _ = tf.timestep_su2_finite_tdvp(
            psi, MPO, tf.SU2TDVP(dt=0.1, imaginary=True, krylovdim=12))
        pj, _ = jf.timestep_su2_finite_tdvp(
            pj, MPO_J, jf.SU2TDVP(dt=0.1, imaginary=True, krylovdim=12))
    e1 = tf.energy_reduced(psi, MPO)
    assert abs(e1 - jf.energy_reduced(pj, MPO_J)) < 1e-10
    assert _e_exact(4) - 1e-9 < e1 < e0 - 1e-3


def test_tdvp_real_time_conserves_energy_and_norm():
    """Five complex128 real-time steps at L=4 from a partly converged
    state: the energy equal to the JAX package's (1e-10) and conserved to
    1e-6, the norm to 1e-9; a real state raises TypeError."""
    (psi, _, _), (pj, _, _) = _dmrg2(4, 4, 4, 1e-2, 2)
    import dataclasses as dc
    pj = dc.replace(pj, sites=tuple(
        jr.RBlocks(s.keys, tuple(v.astype(jnp.complex128) for v in s.vals))
        for s in pj.sites))
    with pytest.raises(TypeError):
        tf.timestep_su2_finite_tdvp(psi, MPO, tf.SU2TDVP(dt=0.05))
    psi = psi.astype(torch.complex128)
    e0 = tf.energy_reduced(psi, MPO)
    for _ in range(5):
        psi, _ = tf.timestep_su2_finite_tdvp(psi, MPO,
                                             tf.SU2TDVP(dt=0.05, krylovdim=16))
        pj, _ = jf.timestep_su2_finite_tdvp(pj, MPO_J,
                                            jf.SU2TDVP(dt=0.05, krylovdim=16))
    e1 = tf.energy_reduced(psi, MPO)
    assert abs(e1 - jf.energy_reduced(pj, MPO_J)) < 1e-10
    assert abs(e1 - e0) < 1e-6 and abs(psi.norm() - 1.0) < 1e-9
    for a, b in zip(psi.sites, pj.sites):
        _same(a, b, 1e-9)


def test_dispatchers_route_su2_finite():
    """find_groundstate / changebonds / timestep route the reduced finite
    chain as the JAX package's do (generic DMRG2 and DMRG translate,
    OptimalExpand grows multiplets, TDVP steps)."""
    from mpskit_tpu_torch import (
        DMRG, DMRG2, TDVP, OptimalExpand, changebonds, find_groundstate,
        timestep,
    )

    psi = _carry_psi(jf.SU2FiniteMPS.random(KEY, 4, TJP, target_tj=0,
                                            max_mult=2))
    psi, e, _ = find_groundstate(psi, MPO, DMRG2(tol=1e-10, maxiter=15))
    assert abs(e - _e_exact(4)) < 1e-8
    (pt, _, _), _ = _dmrg2(6, 1, 1, 1e-9, 10, seed=5)
    n0 = [sum(m for _, m in b) for b in pt.bonds[1:-1]]
    grown = changebonds(pt, MPO, OptimalExpand(dims=1))
    n1 = [sum(m for _, m in b) for b in grown.bonds[1:-1]]
    assert all(b >= a for a, b in zip(n0, n1)) and n1 != n0
    p3, e3, _ = find_groundstate(grown, MPO, DMRG(tol=1e-11, maxiter=15))
    assert e3 <= tf.energy_reduced(pt, MPO) + 1e-10
    pc = p3.astype(torch.complex128)
    e_before = tf.energy_reduced(pc, MPO)
    pc, envs = timestep(pc, MPO, 0.0, 0.05, TDVP(expalg_m=16))
    assert envs is None
    assert abs(tf.energy_reduced(pc, MPO) - e_before) < 1e-8
