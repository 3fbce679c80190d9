"""Evolution MPOs in the PyTorch port against the JAX package and dense
matrices: make_time_mpo (WI, WII, TaylorCluster), DenseMPO, the
MPO-times-MPS application and time_evolve.

Inputs are made by the JAX package or with numpy from a seed, carried
across with `interop`, and fed to both packages in complex128. The
evolution MPOs are host arrays built by the same arithmetic, so they are
compared elementwise; applied states pass through an SVD, so those are
compared through overlaps and energies."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import expval as jexp
from mpskit_tpu.algorithms.time_evolve import time_evolve as jtime_evolve
from mpskit_tpu.algorithms import tdvp as jtdvp
from mpskit_tpu.algorithms import timeevmpo as jtm
from mpskit_tpu.models import hamiltonians as jham
from mpskit_tpu.operators import apply as japply
from mpskit_tpu.operators import mpo as jmpo
from mpskit_tpu.states import finitemps as jmps
from mpskit_tpu.states import infinitemps as jimps
from mpskit_tpu_torch import (
    TDVP, WI, WII, DenseMPO, FiniteMPS, TaylorCluster, expectation_value,
    make_time_mpo, time_evolve,
)
from mpskit_tpu_torch.interop import (
    finite_mps_from_numpy, infinite_mps_from_numpy, mpo_from_numpy,
)
from mpskit_tpu_torch.operators.apply import (
    apply_densempo_finite, apply_densempo_infinite,
)

torch.set_num_threads(1)

C128 = torch.complex128


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _carry(pj):
    return finite_mps_from_numpy(np.asarray(pj.ALs), np.asarray(pj.ARs),
                                 np.asarray(pj.AC), pj.center, "cpu")


def _models(name):
    """(port H, JAX H) with the same FSM."""
    if name == "tfim":
        Hj = jham.transverse_field_ising(g=1.3)
    else:
        Hj = jham.heisenberg_XXX(spin=0.5)
    return mpo_from_numpy(np.asarray(Hj.W)), Hj


_JAX_ALGS = {"WI": jtm.WI(), "WII": jtm.WII(), "TC2": jtm.TaylorCluster(2),
             "TC3": jtm.TaylorCluster(3)}
_ALGS = {"WI": WI(), "WII": WII(), "TC2": TaylorCluster(2),
         "TC3": TaylorCluster(3)}


@functools.cache
def _jax_time_mpo(model, alg, dt):
    """JAX's evolution MPO (cached: its WII compiles one Arnoldi
    exponential per block pair)."""
    return jtm.make_time_mpo(_models(model)[1], dt, _JAX_ALGS[alg])


def _dense(O, L, ends=0):
    """The dense operator of a DenseMPO on L sites, with boundary vectors
    selecting virtual level `ends` on both sides (0 for the evolution
    MPOs; the ragged edges of to_densempo are one level wide)."""
    Os = [np.asarray(O.site(i)) for i in range(L)]
    d = Os[0].shape[2]
    E = np.zeros((Os[0].shape[0], 1, 1), complex)
    E[ends, 0, 0] = 1.0
    for o in Os:
        dim = E.shape[1]
        E = np.einsum("aST,abst->bSsTt", E, o).reshape(
            o.shape[1], dim * d, dim * d)
    return E[ends]


@pytest.mark.parametrize("model,alg,tol", [
    ("tfim", "WI", 1e-13), ("tfim", "WII", 1e-10), ("tfim", "TC2", 1e-13),
    ("tfim", "TC3", 1e-13), ("heis", "WI", 1e-13), ("heis", "WII", 1e-10),
    ("heis", "TC2", 1e-13)])
def test_make_time_mpo_matches_jax(model, alg, tol):
    """Every site tensor elementwise against JAX (WII through the two
    packages' Arnoldi exponentials, the others through the same host
    arithmetic), at dt = 0.05."""
    Ht, _ = _models(model)
    Ut, Uj = make_time_mpo(Ht, 0.05, _ALGS[alg]), _jax_time_mpo(model, alg,
                                                               0.05)
    assert isinstance(Ut, DenseMPO) and Ut.period == Uj.period
    for a, b in zip(Ut.Os, Uj.Os):
        assert isinstance(a, np.ndarray) and a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=tol)


def test_time_mpo_against_the_dense_exponential():
    """The JAX package's bounds on the port: WI and WII within 3 L dt^2 of
    exp(-i H dt) (TFIM g=1.3, L=6, dt=0.02), WII closer than WI, and
    TaylorCluster(2) ten times closer than WI."""
    L, dt = 6, 0.02
    Ht, _ = _models("tfim")
    U = np.linalg.eigh(Ht.to_matrix(L))
    exact = U[1] @ np.diag(np.exp(-1j * dt * U[0])) @ U[1].conj().T
    errs = {name: np.linalg.norm(_dense(make_time_mpo(Ht, dt, a), L) - exact)
            / np.linalg.norm(exact)
            for name, a in (("WI", WI()), ("WII", WII()),
                            ("TC2", TaylorCluster(2)))}
    assert errs["WI"] < 3 * L * dt ** 2 and errs["WII"] < 3 * L * dt ** 2
    assert errs["WII"] < errs["WI"] and errs["TC2"] < errs["WI"] / 10


def test_densempo_compress_matmul_and_to_densempo():
    """Through the dense matrix at L=4 (spin-1/2 Heisenberg), to 1e-12:
    to_densempo equals H.to_matrix and JAX's to_densempo, with its edge
    bonds compressed (1 and d^2 wide at site 0); U @ U equals the product of the dense
    U's, and compressing it keeps the matrix; stacked_uniform pads the
    ragged edges with zeros."""
    L = 4
    Ht, Hj = _models("heis")
    Hd = _dense(Ht.to_densempo(L), L)
    np.testing.assert_allclose(Hd, Ht.to_matrix(L), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Hd, _dense(Hj.to_densempo(L), L), rtol=0,
                               atol=1e-12)
    ragged = Ht.to_densempo(L)
    assert ragged.Os[0].shape[:2] == (1, 4) and ragged.Os[-1].shape[1] == 1

    U = jmpo.DenseMPO.from_array(
        np.asarray(_jax_time_mpo("heis", "WI", 0.05).site(0)), L)
    Ut = DenseMPO.from_array(np.asarray(U.site(0)), period=L)
    UU = Ut @ Ut
    assert UU.site(0).shape[0] == Ut.site(0).shape[0] ** 2
    np.testing.assert_allclose(_dense(UU, L), _dense(Ut, L) @ _dense(Ut, L),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(_dense(UU, L), _dense(U @ U, L), rtol=0,
                               atol=1e-12)
    S = ragged.stacked_uniform()
    assert S.shape == (L, max(max(o.shape[:2]) for o in ragged.Os),
                       max(max(o.shape[:2]) for o in ragged.Os), 2, 2)
    for i, o in enumerate(ragged.Os):
        np.testing.assert_array_equal(S[i, : o.shape[0], : o.shape[1]], o)
        assert not S[i, o.shape[0]:].any() and not S[i, :, o.shape[1]:].any()
    np.testing.assert_allclose(_dense(DenseMPO(ragged.Os).compress(), L),
                               Hd, rtol=0, atol=1e-12)


@pytest.mark.parametrize("alg", ["WII", "WI", "identity"])
def test_apply_densempo_finite_matches_jax(alg):
    """O |psi> on a JAX random state (TFIM g=1.3, L=6, D=8): the port's
    result against JAX's, |<a|b>| = 1 to 1e-10; the identity MPO leaves
    the state alone to 1e-10; the caller's state is unchanged."""
    L, D = 6, 8
    Ht, _ = _models("tfim")
    pj = jmps.FiniteMPS.random(jax.random.PRNGKey(2), L, 2, D,
                               dtype=jnp.complex128)
    if alg == "identity":
        Oj = jmpo.DenseMPO.from_array(jnp.eye(2, dtype=pj.dtype)[None, None],
                                      period=L)
        Ot = DenseMPO.from_array(np.eye(2, dtype=complex)[None, None], L)
    else:
        Oj, Ot = _jax_time_mpo("tfim", alg, 0.05), \
            make_time_mpo(Ht, 0.05, _ALGS[alg])
    pt = _carry(pj)
    before = pt.AC.clone()
    qt = apply_densempo_finite(Ot, pt)
    qj = japply.apply_densempo_finite(Oj, pj)
    assert torch.equal(pt.AC, before)
    assert qt.D == D and qt.AC.dtype == C128
    assert abs(abs(complex(qt.dot(_carry(qj)))) - 1.0) <= 1e-10
    if alg == "identity":
        assert abs(abs(complex(qt.dot(pt))) - 1.0) <= 1e-10


def test_apply_densempo_finite_truncates_and_composes():
    """Two applications at D=16 against one of U @ U (the JAX package's
    product-consistency case, TFIM g=1.2, L=6, dt=0.03): overlap 1 within
    1e-5; a smaller Dmax cuts the bond dimension."""
    L, D = 6, 16
    Hj = jham.transverse_field_ising(g=1.2)
    Ht = mpo_from_numpy(np.asarray(Hj.W))
    U = make_time_mpo(Ht, 0.03, WII())
    psi = FiniteMPS.random(L, 2, D, C128, "cpu",
                           torch.Generator().manual_seed(2))
    a = apply_densempo_finite(U, apply_densempo_finite(U, psi, Dmax=D),
                              Dmax=D)
    b = apply_densempo_finite(U @ U, psi, Dmax=D)
    assert abs(abs(complex(a.dot(b))) - 1.0) < 1e-5
    small = apply_densempo_finite(U, psi, Dmax=4)
    assert small.D == 4 and small.ARs.shape == (L, 4, 2, 4)


def test_apply_densempo_infinite_matches_jax():
    """WI of TFIM on a JAX random uniform state (D=4 -> 8): the energy
    density of the gauge-fixed result against JAX's to 1e-9."""
    Hj = jham.transverse_field_ising_lattice(g=1.5)
    Ht = mpo_from_numpy(np.asarray(Hj.W))
    pj = jimps.InfiniteMPS.random(jax.random.PRNGKey(4), 1, 2, 4)
    Oj, Ot = jtm.make_time_mpo(Hj, 0.05, jtm.WI()), \
        make_time_mpo(Ht, 0.05, WI())
    qj = japply.apply_densempo_infinite(Oj, pj)
    pt = infinite_mps_from_numpy(np.asarray(pj.AL), np.asarray(pj.AR),
                                 np.asarray(pj.AC), np.asarray(pj.C), "cpu")
    qt = apply_densempo_infinite(Ot, pt)
    assert qt.D == 8
    qc = infinite_mps_from_numpy(np.asarray(qj.AL), np.asarray(qj.AR),
                                 np.asarray(qj.AC), np.asarray(qj.C), "cpu")
    np.testing.assert_allclose(_np(expectation_value(qt, Ht)),
                               _np(expectation_value(qc, Ht)), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("alg", ["TDVP", "WII"])
def test_time_evolve_matches_jax(alg):
    """time_evolve over t = 0, 0.02, 0.04 from the same state
    (spin-1/2 Heisenberg, L=6, D=8, complex128): the energy to 1e-9 and
    the overlap to 1 - 1e-9 against JAX."""
    L, D = 6, 8
    Ht, Hj = _models("heis")
    pj = jmps.FiniteMPS.random(jax.random.PRNGKey(5), L, 2, D,
                               dtype=jnp.complex128)
    ja, ta = (jtdvp.TDVP(), TDVP()) if alg == "TDVP" else (jtm.WII(), WII())
    t_span = np.linspace(0, 0.04, 3)
    qj, _ = jtime_evolve(pj, Hj, t_span, ja)
    qt, envs = time_evolve(_carry(pj), Ht, t_span, ta)
    assert envs is None
    assert abs(float(expectation_value(qt, Ht))
               - float(jexp.expectation_value(qj, Hj))) <= 1e-9
    assert abs(complex(qt.dot(_carry(qj)))) >= 1 - 1e-9


def test_time_evolve_with_mpos_follows_the_exact_evolution():
    """WII and TaylorCluster(2) through time_evolve at L=6, D=8 = 2^(L/2)
    (no truncation), t = 0, 0.02, 0.04 from a seeded random state: the
    distance to exp(-i H t) psi0 within the JAX test's 3 L dt^2 per step,
    TaylorCluster(2) well inside it."""
    L, D, dt = 6, 8, 0.02
    Ht, _ = _models("tfim")
    psi0 = FiniteMPS.random(L, 2, D, C128, "cpu",
                            torch.Generator().manual_seed(6))

    def vec(psi):
        p = psi.move_center(0)
        v = _np(p.AC)[:1]
        for i in range(1, L):
            v = np.einsum("...m,mpr->...pr", v, _np(p.ARs[i]))
        return v[..., :1].reshape(-1)

    E, V = np.linalg.eigh(Ht.to_matrix(L))
    exact = V @ (np.exp(-1j * E * 2 * dt) * (V.conj().T @ vec(psi0)))
    for alg, bound in ((WII(), 2 * 3 * L * dt ** 2),
                       (TaylorCluster(2), 2 * 3 * L * dt ** 2 / 10)):
        psi, _ = time_evolve(psi0, Ht, [0.0, dt, 2 * dt], alg)
        v = vec(psi)
        v = v * np.exp(-1j * np.angle(np.vdot(exact, v)))
        assert np.linalg.norm(v - exact) < bound


def test_time_evolve_threads_infinite_environments():
    """An InfiniteMPS under TDVP: time_evolve returns the last step's
    environments, and a second span warm-started from them reaches the
    energy density of the same span started cold, to 1e-9 (TFIM g=1.5,
    D=6, from a JAX random state)."""
    Hj = jham.transverse_field_ising_lattice(g=1.5)
    Ht = mpo_from_numpy(np.asarray(Hj.W))
    pj = jimps.InfiniteMPS.random(jax.random.PRNGKey(7), 1, 2, 6,
                                  dtype=jnp.complex128)
    pt = infinite_mps_from_numpy(np.asarray(pj.AL), np.asarray(pj.AR),
                                 np.asarray(pj.AC), np.asarray(pj.C), "cpu")
    p1, envs = time_evolve(pt, Ht, [0.0, 0.05])
    assert envs is not None
    warm, _ = time_evolve(p1, Ht, [0.05, 0.1, 0.15], envs=envs)
    cold, _ = time_evolve(p1, Ht, [0.05, 0.1, 0.15])
    np.testing.assert_allclose(_np(expectation_value(warm, Ht)),
                               _np(expectation_value(cold, Ht)), rtol=0,
                               atol=1e-9)


def test_time_evolve_rejects_what_it_does_not_take():
    Ht, _ = _models("tfim")
    psi = FiniteMPS.random(4, 2, 4, C128, "cpu",
                           torch.Generator().manual_seed(0))
    with pytest.raises(TypeError):
        make_time_mpo(Ht, 0.05, TDVP())
    with pytest.raises(TypeError):
        time_evolve(psi, Ht, [0.0, 0.1], alg="WII")
