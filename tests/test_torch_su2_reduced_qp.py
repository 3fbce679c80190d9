"""The SU(2)-reduced quasiparticles of the PyTorch port against the JAX
package on the CPU, float64: the charged bases, the reduced null space,
every charged contraction (pushes, sources, the charged AC derivative),
the momentum-phased charged environments, and the spin-1 excitation at
p = pi against the JAX package, the port's dense QP on the embedded
state and the Haldane gap. The JAX ground states come from the JAX
reduced VUMPS and are carried across with
`interop.su2_reduced_state_from_numpy`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.symmetry import su2 as jsu2
from mpskit_tpu.symmetry import su2_reduced as jr
from mpskit_tpu.symmetry import su2_reduced_qp as jq
from mpskit_tpu_torch.interop import (
    rblocks_from_numpy, su2_reduced_state_from_numpy,
)
from mpskit_tpu_torch.symmetry import su2 as tsu2
from mpskit_tpu_torch.symmetry import su2_reduced as tr
from mpskit_tpu_torch.symmetry import su2_reduced_qp as tq

torch.set_num_threads(1)

TJP, TKE = 2, 2           # spin-1 physical leg, spin-1 excitation
MULT = ((1, 2), (3, 1))   # dense D = 8
KEY = jax.random.PRNGKey(3)
E_HALDANE = 0.41047925


def _carry(rb):
    return rblocks_from_numpy(rb.keys, [np.asarray(v) for v in rb.vals],
                              device="cpu")


def _same(t, j, tol):
    assert t.keys == tuple(j.keys)
    for k in t.keys:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=0,
                                   atol=tol)


@functools.lru_cache(maxsize=None)
def _gs(mult=MULT, tol=1e-10, maxiter=200):
    """The JAX reduced ground state and its carried copy."""
    stj = jr.SU2ReducedState.random(jax.random.PRNGKey(0),
                                    jsu2.SU2Bond(mult), TJP)
    stj, _, eps = jr.find_groundstate_su2_reduced(
        stj, jr.heisenberg_reduced(TJP), tol=tol, maxiter=maxiter)
    assert eps < 1e-7
    st = su2_reduced_state_from_numpy(
        *((x.keys, [np.asarray(v) for v in x.vals])
          for x in (stj.AL, stj.AR, stj.AC, stj.C)), TJP, device="cpu")
    return st, stj


def _rand(keys, secs, key, which):
    d = dict(secs)
    return jr.RBlocks(keys, tuple(
        jax.random.normal(jax.random.fold_in(key, i),
                          (d[k[0]], d[k[which]]), jnp.float64)
        for i, k in enumerate(keys)))


def _rand_csite(key, secs):
    return _rand(jq.csite_keys(secs, TJP, TKE, secs), secs, key, 2)


def _rand_cenv(key, secs, tka):
    return _rand(jq.cenv_keys(secs, tka, TKE), secs, key, 2)


def _rand_env(key, secs, tk):
    return _rand(jr.env_keys(jsu2.SU2Bond(tuple(secs)), tk), secs, key, 1)


def test_charged_roundtrips():
    """The charged site and environment embeddings equal the JAX
    package's (1e-12), restrict inverts them, and they are isometric."""
    B = _rand_csite(KEY, MULT)
    A = tq.embed_csite(_carry(B), MULT, TJP, TKE)
    np.testing.assert_allclose(A, jq.embed_csite(B, MULT, TJP, TKE),
                               atol=1e-12)
    _same(tq.restrict_csite(A, MULT, TJP, TKE, device="cpu"), B, 1e-12)
    assert abs(np.linalg.norm(A) - float(tr.tree_norm(_carry(B)))) < 1e-12
    for tka in (0, 2):
        for twist in (False, True):
            G = _rand_cenv(jax.random.PRNGKey(5), MULT, tka)
            E = tq.embed_cenv(_carry(G), MULT, tka, TKE, twist)
            np.testing.assert_allclose(
                E, jq.embed_cenv(G, MULT, tka, TKE, twist), atol=1e-12)
            _same(tq.restrict_cenv(E, MULT, tka, TKE, twist, device="cpu"),
                  G, 1e-12)


def test_nullspace_and_vlx():
    """left_null_reduced is a dense isometry orthogonal to AL with the JAX
    package's null sectors; vl_x and vl_pullback equal JAX's on JAX's VL
    (1e-12), and the pullback inverts vl_x."""
    st, stj = _gs()
    VL = tq.left_null_reduced(st.AL, TJP)
    VLj = jq.left_null_reduced(stj.AL, TJP)
    assert tq.null_sectors(VL) == jq.null_sectors(VLj)
    nbond = tsu2.SU2Bond(tq.null_sectors(VL))
    bond = tsu2.SU2Bond(MULT)
    VLd = tr.embed_site(VL, bond, TJP, nbond)
    ALd = tr.embed_site(st.AL, bond, TJP, bond)
    np.testing.assert_allclose(np.einsum("lpm,lpn->mn", VLd, VLd),
                               np.eye(nbond.dim), atol=1e-10)
    np.testing.assert_allclose(np.einsum("lpm,lpn->mn", VLd, ALd), 0.0,
                               atol=1e-10)
    Xj = jq.random_x(KEY, VLj, MULT, TKE, jnp.float64)
    Bj = jq.vl_x(VLj, Xj, TJP, TKE)
    B = tq.vl_x(_carry(VLj), _carry(Xj), TJP, TKE)
    _same(B, Bj, 1e-12)
    X2 = tq.vl_pullback(_carry(VLj), B, _carry(Xj), TJP, TKE)
    _same(X2, jq.vl_pullback(VLj, Bj, Xj, TJP, TKE), 1e-12)
    _same(X2, Xj, 1e-10)


def test_charged_kernels_match_jax():
    """The charged pushes and sources through the first FSM entry and an
    identity diagonal equal the JAX package's (1e-12)."""
    st, stj = _gs()
    mj, mpo = jr.heisenberg_reduced(TJP), tr.heisenberg_reduced(TJP)
    Bj = _rand_csite(jax.random.PRNGKey(9), MULT)
    B = _carry(Bj)
    for entry in (mpo.entries[0] + (False,), (0, 0, 0, 1.0, True)):
        a, b = entry[0], entry[1]
        tka, tkb = mpo.channels[a], mpo.channels[b]
        lB = _rand_cenv(jax.random.PRNGKey(11), MULT, tka)
        _same(tq.cpush_left(_carry(lB), entry, mpo, TKE, st.AL, st.AR,
                            tq._cenv_zero(MULT, tkb, TKE, B)),
              jq.cpush_left(lB, entry, mj, TKE, stj.AL, stj.AR,
                            jq._cenv_zero(MULT, tkb, TKE, Bj.vals[0])), 1e-12)
        gl = _rand_env(jax.random.PRNGKey(12), MULT, tka)
        _same(tq.csrc_left(_carry(gl), entry, mpo, TKE, st.AL, B,
                           tq._cenv_zero(MULT, tkb, TKE, B)),
              jq.csrc_left(gl, entry, mj, TKE, stj.AL, Bj,
                           jq._cenv_zero(MULT, tkb, TKE, Bj.vals[0])), 1e-12)
        rB = _rand_cenv(jax.random.PRNGKey(13), MULT, tkb)
        _same(tq.cpush_right(_carry(rB), entry, mpo, TKE, st.AR, st.AL,
                             tq._cenv_zero(MULT, tka, TKE, B)),
              jq.cpush_right(rB, entry, mj, TKE, stj.AR, stj.AL,
                             jq._cenv_zero(MULT, tka, TKE, Bj.vals[0])),
              1e-12)
        gr = _rand_env(jax.random.PRNGKey(14), MULT, tkb)
        _same(tq.csrc_right(_carry(gr), entry, mpo, TKE, st.AR, B,
                            tq._cenv_zero(MULT, tka, TKE, B)),
              jq.csrc_right(gr, entry, mj, TKE, stj.AR, Bj,
                            jq._cenv_zero(MULT, tka, TKE, Bj.vals[0])), 1e-12)


def test_cac_apply_matches_jax():
    """The three-term charged AC derivative on random environments equals
    the JAX package's (1e-12)."""
    st, stj = _gs()
    mj, mpo = jr.heisenberg_reduced(TJP), tr.heisenberg_reduced(TJP)
    Bj = _rand_csite(jax.random.PRNGKey(21), MULT)
    envs = []
    for lvl, tk in enumerate(mj.channels):
        envs.append((_rand_env(jax.random.fold_in(KEY, 50 + lvl), MULT, tk),
                     _rand_env(jax.random.fold_in(KEY, 60 + lvl), MULT, tk),
                     _rand_cenv(jax.random.fold_in(KEY, 70 + lvl), MULT, tk),
                     _rand_cenv(jax.random.fold_in(KEY, 80 + lvl), MULT, tk)))
    glj, grj, lBj, rBj = (list(x) for x in zip(*envs))
    out = tq.cac_apply(*([_carry(g) for g in x] for x in (glj, grj, lBj, rBj)),
                       mpo, TKE, st.AL, st.AR, _carry(Bj))
    _same(out, jq.cac_apply(glj, grj, lBj, rBj, mj, TKE, stj.AL, stj.AR, Bj),
          1e-12)


def test_qp_env_fixed_point():
    """The solved charged tails at p = pi equal the JAX package's (1e-10)
    and satisfy lB = phase (T lB + sources) on the identity levels."""
    st, stj = _gs()
    mj, mpo = jr.heisenberg_reduced(TJP), tr.heisenberg_reduced(TJP)
    glj, grj, _, _ = jr.reduced_ham_envs(stj.AL, stj.AR, stj.C, mj, TJP,
                                         tol=1e-12)
    gls, grs = [_carry(g) for g in glj], [_carry(g) for g in grj]
    VLj = jq.left_null_reduced(stj.AL, TJP)
    Xj = jr.tree_normalize(jq.random_x(KEY, VLj, MULT, TKE, jnp.float64))
    Bj = jq.vl_x(VLj, Xj, TJP, TKE)
    B = _carry(Bj)
    lBs, rBs = tq.qp_envs_reduced(B, st.AL, st.AR, gls, grs, mpo, TKE, -1.0,
                                  tol=1e-12)
    lBj, rBj = jq.qp_envs_reduced(Bj, stj.AL, stj.AR, glj, grj, mj, TKE,
                                  jnp.asarray(-1.0), tol=1e-12)
    for a, b in zip(lBs + rBs, lBj + rBj):
        _same(a, b, 1e-10)
    w = mpo.odim
    for b in (0, w - 1):
        ident = (b, b, 0, 1.0, True)
        rhs = tq.cpush_left(lBs[b], ident, mpo, TKE, st.AL, st.AR,
                            tq._cenv_zero(MULT, mpo.channels[b], TKE, B))
        for e in [en + (False,) for en in mpo.entries if en[1] == b]:
            if e[0] != b:
                rhs = tq.cpush_left(lBs[e[0]], e, mpo, TKE, st.AL, st.AR, rhs)
            rhs = tq.csrc_left(gls[e[0]], e, mpo, TKE, st.AL, B, rhs)
        rhs = tq.csrc_left(gls[b], ident, mpo, TKE, st.AL, B, rhs)
        assert float(torch.linalg.vector_norm(lBs[b].flat + rhs.flat)) < 1e-9


def _qp(mult, tol, maxiter, qp_tol):
    st, stj = _gs(mult, tol, maxiter)
    mpo = tr.heisenberg_reduced(TJP)
    es, qps = tq.excitations_su2_reduced(mpo, st, np.pi, tke=TKE, tol=qp_tol)
    esj, _ = jq.excitations_su2_reduced(jr.heisenberg_reduced(TJP), stj,
                                        np.pi, tke=TKE, tol=qp_tol)
    return st, float(es[0, 0]), float(esj[0, 0]), qps


def test_reduced_qp_matches_dense_embedded():
    """The reduced spin-1 QP energy at p = pi equals the JAX package's
    (1e-8) and the port's dense quasiparticle solve on the embedded state
    (1e-6); the excitations dispatcher routes a ReducedMPO to it."""
    from mpskit_tpu_torch import QuasiparticleAnsatz, excitations
    from mpskit_tpu_torch.interop import infinite_mps_from_numpy, \
        mpo_from_numpy

    st, e_red, e_j, qps = _qp(MULT, 1e-10, 200, 1e-9)
    assert abs(e_red - e_j) < 1e-8 and isinstance(qps[0][0], tq.ReducedQP)
    bond = tsu2.SU2Bond(MULT)
    ALd = tr.embed_site(st.AL, bond, TJP, bond)[None]
    ARd = tr.embed_site(st.AR, bond, TJP, bond)[None]
    Cd = tr.embed_c(st.C, bond)[None]
    psi = infinite_mps_from_numpy(ALd, ARd, np.einsum("ilpm,imr->ilpr", ALd,
                                                      Cd), Cd, device="cpu")
    mpo = tr.heisenberg_reduced(TJP)
    H = mpo_from_numpy(mpo.dense_fsm()[None])
    es_d, _ = excitations(H, QuasiparticleAnsatz(tol=1e-9), np.pi, psi,
                          num=1)
    assert abs(e_red - float(es_d[0, 0])) < 1e-6
    es, _ = excitations(mpo, QuasiparticleAnsatz(tol=1e-9), np.pi, st,
                        sector=TKE)
    assert abs(float(es[0, 0]) - e_red) < 1e-8


def test_haldane_gap_reduced_small():
    """The reduced Haldane-gap solve at dense D=14 from the same ground
    state: within 1e-8 of the JAX package's."""
    _, gap, gapj, _ = _qp(((1, 3), (3, 2)), 1e-10, 200, 1e-9)
    assert abs(gap - gapj) < 1e-8 and 0.3 < gap < 0.6


@pytest.mark.slow
def test_haldane_gap_reduced():
    """The flagship at dense D=42: the Haldane gap within 1e-3 of
    0.41047925 (the JAX test's bound) and 1e-8 of the JAX package's."""
    _, gap, gapj, _ = _qp(((1, 8), (3, 5), (5, 1)), 1e-9, 150, 1e-7)
    assert abs(gap - E_HALDANE) < 1e-3 and abs(gap - gapj) < 1e-8
