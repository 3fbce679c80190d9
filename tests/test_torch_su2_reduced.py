"""The SU(2) reduced-coordinate backend of the PyTorch port against the JAX
package on the CPU, float64: the probed structure coefficients, the
embeddings, the reduced MPOs, every reduced contraction (transfers, the AC
and C effective Hamiltonians), the gauge moves, the environments and the
reduced VUMPS of the spin-1 Heisenberg chain. Both packages compute from
the same numbers: the JAX blocks are drawn from PRNGKeys and carried
across with `interop.rblocks_from_numpy`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.symmetry import su2 as jsu2
from mpskit_tpu.symmetry import su2_reduced as jr
from mpskit_tpu_torch.interop import (
    rblocks_from_numpy, su2_reduced_state_from_numpy,
)
from mpskit_tpu_torch.symmetry import su2 as tsu2
from mpskit_tpu_torch.symmetry import su2_reduced as tr

torch.set_num_threads(1)

BOND_J = jsu2.SU2Bond(((1, 3), (3, 2), (5, 1)))   # dense D = 20
BOND = tsu2.SU2Bond(((1, 3), (3, 2), (5, 1)))
TJP = 2
KEY = jax.random.PRNGKey(7)
E0_HEISENBERG_S1 = -1.401484038971


def _carry(rb):
    return rblocks_from_numpy(rb.keys, [np.asarray(v) for v in rb.vals],
                              device="cpu")


def _carry_state(st):
    return su2_reduced_state_from_numpy(
        *((x.keys, [np.asarray(v) for v in x.vals])
          for x in (st.AL, st.AR, st.AC, st.C)), st.tjp, device="cpu")


def _same(t, j, tol):
    """Equal keys and blocks within tol (absolute)."""
    assert t.keys == tuple(j.keys)
    for k in t.keys:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=0,
                                   atol=tol)


def _rand_env(key, tk):
    secs = dict(jr._bond_sectors(BOND_J))
    keys = jr.env_keys(BOND_J, tk)
    vals = tuple(jax.random.normal(jax.random.fold_in(key, i),
                                   (secs[tb], secs[tn]), jnp.float64)
                 for i, (tb, tn) in enumerate(keys))
    return jr.RBlocks(keys, vals)


@pytest.fixture(scope="module")
def site():
    B = jr.random_site(KEY, BOND_J, TJP)
    return B, _carry(B)


def test_probe_coefficients_match_jax():
    """A sample of every probed structure coefficient (and the CG tensors
    and bases behind them) equals the JAX package's to 1e-14."""
    spins = (0, 1, 2, 3, 4, 5)
    n = 0
    for tjx in spins:
        for tjy in spins:
            for tjm in spins:
                for tjn in spins:
                    args = (tjx, tjy, tjm, tjn)
                    for f in ("_probe_transfer_left", "_probe_transfer_right",
                              "_probe_ac"):
                        a = getattr(tr, f)(0, 2, 2, TJP, *args)
                        b = getattr(jr, f)(0, 2, 2, TJP, *args)
                        assert abs(a - b) <= 1e-14
                        a = getattr(tr, f)(2, 2, 0, TJP, *args)
                        b = getattr(jr, f)(2, 2, 0, TJP, *args)
                        assert abs(a - b) <= 1e-14
                        n += abs(a) > 1e-14
                    assert abs(tr._probe_ac_identity(TJP, *args)
                               - jr._probe_ac_identity(TJP, *args)) <= 1e-14
                    for f in ("_probe_plain_left", "_probe_plain_right"):
                        assert abs(getattr(tr, f)(TJP, tjx, tjm, tjy, tjn)
                                   - getattr(jr, f)(TJP, tjx, tjm, tjy,
                                                    tjn)) <= 1e-14
            for tka in (0, 2, 4):
                assert abs(tr._probe_c(tka, tjx, tjy, tjx)
                           - jr._probe_c(tka, tjx, tjy, tjx)) <= 1e-14
    assert n > 50
    for args in ((1, 2, 3), (2, 2, 2), (3, 2, 1), (4, 2, 2)):
        np.testing.assert_allclose(tr._cg(*args), jr._cg(*args), atol=1e-15)
    for tj1, tm1, tj2, tm2, tJ, tM in ((1, 1, 1, -1, 0, 0), (3, 1, 2, 2, 5, 3),
                                       (4, -2, 2, 0, 2, -2)):
        assert abs(tsu2.clebsch_gordan2(tj1, tm1, tj2, tm2, tJ, tM)
                   - jsu2.clebsch_gordan2(tj1, tm1, tj2, tm2, tJ, tM)) \
            <= 1e-15


def test_embed_restrict_roundtrip(site):
    """embed_site equals the JAX embedding (1e-12), restrict_site inverts
    it, and the dense norm equals the block norm."""
    Bj, B = site
    A = tr.embed_site(B, BOND, TJP, BOND)
    np.testing.assert_allclose(A, jr.embed_site(Bj, BOND_J, TJP, BOND_J),
                               atol=1e-12)
    _same(tr.restrict_site(A, BOND, TJP, BOND, device="cpu"), Bj, 1e-12)
    assert abs(np.linalg.norm(A) - float(tr.tree_norm(B))) < 1e-12


@pytest.mark.parametrize("tk", [0, 2])
def test_env_embed_roundtrip(tk):
    Gj = _rand_env(KEY, tk)
    G = _carry(Gj)
    E = tr.embed_env(G, BOND, tk)
    np.testing.assert_allclose(E, jr.embed_env(Gj, BOND_J, tk), atol=1e-12)
    _same(tr.restrict_env(E, BOND, tk, device="cpu"), Gj, 1e-12)
    assert abs(np.linalg.norm(E) - float(tr.tree_norm(G))) < 1e-12


def test_identity_and_rho(site):
    Id = tr.identity_c(BOND, device="cpu")
    np.testing.assert_allclose(tr.embed_c(Id, BOND), np.eye(BOND.dim),
                               atol=1e-12)
    Cj = jr.left_qr_reduced(site[0])[1]
    for side in ("left", "right"):
        _same(tr.rho_from_c(_carry(Cj), side), jr.rho_from_c(Cj, side),
              1e-12)


@pytest.mark.parametrize("theta", [None, 0.3])
def test_heisenberg_reduced_two_site(theta):
    """The reduced MPOs equal the JAX package's (channels, entries, dense
    FSM); the Heisenberg one reproduces S.S on two sites."""
    if theta is None:
        mpo, mj = tr.heisenberg_reduced(TJP), jr.heisenberg_reduced(TJP)
    else:
        mpo = tr.bilinear_biquadratic_reduced(TJP, theta)
        mj = jr.bilinear_biquadratic_reduced(TJP, theta)
    assert mpo.channels == mj.channels
    for a, b in zip(mpo.entries, mj.entries):
        assert a[:3] == b[:3] and abs(a[3] - b[3]) <= 1e-14
    W = mpo.dense_fsm()
    np.testing.assert_allclose(W, mj.dense_fsm(), atol=1e-14)
    if theta is None:
        d = TJP + 1
        H2 = np.einsum("bst,buv->sutv", W[0], W[:, -1]).reshape(d * d, d * d)
        np.testing.assert_allclose(H2, tr._spin_ss(TJP), atol=1e-10)


def test_plain_transfer_matches_jax(site):
    Bj, B = site
    vj = _rand_env(jax.random.PRNGKey(3), 0)
    v = _carry(vj)
    _same(tr.rtransfer_left_plain(v, B, B, TJP),
          jr.rtransfer_left_plain(vj, Bj, Bj, TJP), 1e-12)
    _same(tr.rtransfer_right_plain(v, B, B, TJP),
          jr.rtransfer_right_plain(vj, Bj, Bj, TJP), 1e-12)


def test_entry_transfer_matches_jax(site):
    Bj, B = site
    mj, mpo = jr.heisenberg_reduced(TJP), tr.heisenberg_reduced(TJP)
    secs = tr._bond_sectors_from_blocks(B)
    for n, (a, b) in enumerate(((0, 1), (1, 2))):
        e, ej = mpo.entries[n], mj.entries[n]
        if n == 0:
            gj = _rand_env(jax.random.PRNGKey(5), mj.channels[a])
            outj = jr.rtransfer_left_entry(
                gj, ej, mj, Bj, jr._env_zero(secs, mj.channels[b], Bj))
            out = tr.rtransfer_left_entry(
                _carry(gj), e, mpo, B, tr._env_zero(secs, mpo.channels[b], B))
        else:
            gj = _rand_env(jax.random.PRNGKey(6), mj.channels[b])
            outj = jr.rtransfer_right_entry(
                gj, ej, mj, Bj, jr._env_zero(secs, mj.channels[a], Bj))
            out = tr.rtransfer_right_entry(
                _carry(gj), e, mpo, B, tr._env_zero(secs, mpo.channels[a], B))
        _same(out, outj, 1e-12)


def test_rac_apply_matches_jax(site):
    """rac_apply and rc_apply on random environments equal the JAX
    package's (1e-12); the plan of the AC matvec holds its GEMM terms."""
    Bj, B = site
    mj, mpo = jr.heisenberg_reduced(TJP), tr.heisenberg_reduced(TJP)
    glj = [_rand_env(jax.random.fold_in(KEY, 100 + lvl), tk)
           for lvl, tk in enumerate(mj.channels)]
    grj = [_rand_env(jax.random.fold_in(KEY, 200 + lvl), tk)
           for lvl, tk in enumerate(mj.channels)]
    gl, gr = [_carry(g) for g in glj], [_carry(g) for g in grj]
    _same(tr.rac_apply(gl, gr, mpo, B), jr.rac_apply(glj, grj, mj, Bj),
          1e-12)
    Cj = jr.rho_from_c(jr.identity_c(BOND_J), "right")
    _same(tr.rc_apply(gl, gr, mpo, _carry(Cj)), jr.rc_apply(glj, grj, mj, Cj),
          1e-12)
    terms, gemms = tr.rac_terms(gl, gr, mpo, B)
    assert 0 < terms < gemms <= 2 * terms


def test_gauge_identities(site):
    """left_qr_reduced / right_lq_reduced equal the JAX package's (the
    sign-fixed QR is unique), are dense isometries and reconstruct B."""
    Bj, B = site
    AL, C = tr.left_qr_reduced(B)
    ALj, Cj = jr.left_qr_reduced(Bj)
    _same(AL, ALj, 1e-12)
    _same(C, Cj, 1e-12)
    ALd = tr.embed_site(AL, BOND, TJP, BOND)
    np.testing.assert_allclose(np.einsum("lpm,lpn->mn", ALd, ALd),
                               np.eye(BOND.dim), atol=1e-10)
    _same(tr.rmul_c_right(AL, C), Bj, 1e-12)
    C2, AR = tr.right_lq_reduced(B)
    C2j, ARj = jr.right_lq_reduced(Bj)
    _same(AR, ARj, 1e-12)
    _same(C2, C2j, 1e-12)
    _same(tr.rmul_c_left(C2, AR), Bj, 1e-12)


def test_uniform_gauge_and_regauge():
    """The uniform gauge of a random tensor and the regauges equal the JAX
    package's; AC = AL C = C AR."""
    Aj = jr.random_site(jax.random.PRNGKey(11), BOND_J, TJP)
    A = _carry(Aj)
    out = tr.uniform_gauge_reduced(A, TJP)
    outj = jr.uniform_gauge_reduced(Aj, TJP)
    for x, xj in zip(out, outj):
        _same(x, xj, 1e-10)
    AL, AR, AC, C = out
    _same(tr.rmul_c_right(AL, C), jax.tree_util.tree_map(np.asarray, outj[2]),
          1e-8)
    _same(tr.rmul_c_left(C, AR), jax.tree_util.tree_map(np.asarray, outj[2]),
          1e-8)
    _same(tr.regauge_acc_reduced(AC, C),
          jr.regauge_acc_reduced(outj[2], outj[3]), 1e-12)
    _same(tr.regauge_cac_reduced(C, AC),
          jr.regauge_cac_reduced(outj[3], outj[2]), 1e-12)


@functools.lru_cache(maxsize=None)
def _vumps(multiplets, seed, tol, maxiter):
    bj = jsu2.SU2Bond(multiplets)
    stj = jr.SU2ReducedState.random(jax.random.PRNGKey(seed), bj, TJP)
    st = _carry_state(stj)
    outj = jr.find_groundstate_su2_reduced(stj, jr.heisenberg_reduced(TJP),
                                           tol=tol, maxiter=maxiter)
    out = tr.find_groundstate_su2_reduced(st, tr.heisenberg_reduced(TJP),
                                          tol=tol, maxiter=maxiter)
    return out, outj


def test_reduced_environments_match_jax():
    """reduced_ham_envs on a carried state: every level's environment and
    the energy density equal the JAX package's."""
    (st, _, _), (stj, _, _) = _vumps(((1, 2), (3, 1)), 1, 1e-10, 150)
    mj, mpo = jr.heisenberg_reduced(TJP), tr.heisenberg_reduced(TJP)
    gls, grs, e, r = tr.reduced_ham_envs(st.AL, st.AR, st.C, mpo, TJP)
    glj, grj, ej, _ = jr.reduced_ham_envs(stj.AL, stj.AR, stj.C, mj, TJP)
    assert abs(float(e) - float(ej)) < 1e-12 and r < 1e-10
    for a, b in zip(gls + grs, glj + grj):
        _same(a, b, 1e-9)


def test_spin1_heisenberg_vumps_reduced():
    """Spin-1 Heisenberg at dense D=42 from the same start: the energy
    density within 1e-10 of the JAX package's and 5e-5 of the exact one,
    the multiplet Schmidt spectrum within 1e-10 of JAX's, half-integer
    sectors only, the largest in j=1/2."""
    (st, e, eps), (stj, ej, epsj) = _vumps(((1, 8), (3, 5), (5, 1)), 0,
                                           1e-11, 200)
    assert eps < 1e-10 and epsj < 1e-10
    assert abs(e - ej) < 1e-10 and abs(e - E0_HEISENBERG_S1) < 5e-5
    spec, specj = tr.schmidt_spectrum_reduced(st), \
        jr.schmidt_spectrum_reduced(stj)
    assert set(spec) == set(specj) == {1, 3, 5}
    for k in spec:
        np.testing.assert_allclose(spec[k], specj[k], atol=1e-10)
    assert spec[1][0] == max(v[0] for v in spec.values())


def test_reduced_energy_matches_dense_su2_vumps():
    """The reduced VUMPS at dense D=8 against the port's dense-projector
    SU(2) VUMPS (1e-5, as the JAX test) and the JAX reduced energy
    (1e-10)."""
    from mpskit_tpu_torch import heisenberg_XXX

    (st, e_red, _), (_, ej, _) = _vumps(((1, 2), (3, 1)), 1, 1e-10, 150)
    assert abs(e_red - ej) < 1e-10
    sp = tsu2.SU2InfiniteMPS.random(tsu2.SU2Bond(((1, 2), (3, 1))), 2,
                                    device="cpu")
    _, envs, _ = tsu2.find_groundstate_su2_vumps(
        sp, heisenberg_XXX(spin=1, dtype=np.float64))
    assert abs(e_red - float(envs.e_density) / 4.0) < 1e-5
