"""The statmech boundaries of the PyTorch port (the exact dominant Ritz
solve, the small spectra, the fixed-point uniqueness check, the classical
transfer MPOs, the DenseMPO channel environments, boundary VUMPS / VOMPS /
GradientGrassmann on one row, an MPOHamiltonian row and two rows) against
the JAX package on the CPU.

The same numpy inputs, or states made by the JAX package and carried
across with `interop`, go to both packages in complex128 at D <= 12.
Environments and eigenvectors are fixed only up to scale and phase, so
the tests compare the leading eigenvalues, the normalized pairings, the
local Rayleigh quotients, eps, Schmidt values and the free energy.

The port solves the dominant Ritz pair of each Arnoldi restart exactly;
the JAX package runs a fixed 300-step power iteration on it, which stops
short where a transfer operator's gap is small (ROADMAP.md, known
reference-side defects). Where a comparison runs through such a gauge fix
or environment, the JAX side runs with the power iteration taken to
convergence (`jax_converged_ritz`), the same algorithm with its small
solve finished."""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import grassmann as jgr
from mpskit_tpu.algorithms import statmech as jsm
from mpskit_tpu.algorithms.expval import expectation_value as jexpval
from mpskit_tpu.environments import infinite_mpo as jimpo
from mpskit_tpu.linalg import arnoldi as jarn
from mpskit_tpu.linalg import fixedpoint as jfp
from mpskit_tpu.models import statmech as jmod
from mpskit_tpu.operators.mpo import MPOHamiltonian as JMPOHamiltonian
from mpskit_tpu.operators.multiline import MPOMultiline as JMPOMultiline
from mpskit_tpu.states.infinitemps import InfiniteMPS as JInfiniteMPS
from mpskit_tpu.states.multiline import MPSMultiline as JMPSMultiline
from mpskit_tpu_torch import (
    VOMPS, GradientGrassmann, InfiniteMPS, MPOMultiline, MPSMultiline,
    VUMPS_Boundary, classical_ising, expectation_value, leading_boundary,
)
from mpskit_tpu_torch.algorithms import statmech as tsm
from mpskit_tpu_torch.environments import infinite_mpo as timpo
from mpskit_tpu_torch.interop import dense_mpo_from_numpy, \
    infinite_mps_from_numpy, mpo_from_numpy
from mpskit_tpu_torch.linalg import arnoldi as tarn
from mpskit_tpu_torch.linalg import fixedpoint as tfp
from mpskit_tpu_torch.models import statmech as tmod

torch.set_num_threads(1)

# the leading eigenvalue per site of the critical 2D Ising transfer matrix
# (Onsager): sqrt(2) exp(2 G / pi), G Catalan's constant
ONSAGER = float(np.sqrt(2) * np.exp(2 * 0.915965594177219015 / np.pi))


_JAX_SMALL_EIG = jarn.small_eig_dominant


@pytest.fixture
def jax_converged_ritz():
    """The JAX package's dominant Ritz pair by 5000 power steps in place of
    300. The jit caches are cleared on entry and exit, so that no function
    traced with the other step count is reused."""
    jarn.small_eig_dominant = functools.partial(_JAX_SMALL_EIG, iters=5000)
    jax.clear_caches()
    try:
        yield
    finally:
        jarn.small_eig_dominant = _JAX_SMALL_EIG
        jax.clear_caches()


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _carry(pj):
    return infinite_mps_from_numpy(np.asarray(pj.AL), np.asarray(pj.AR),
                                   np.asarray(pj.AC), np.asarray(pj.C),
                                   "cpu")


def _schmidt(C):
    return np.sort(np.linalg.svd(_np(C), compute_uv=False))[::-1]


def _local_lams(psi, Os, GLs, GRs, ac_apply):
    """<AC_i| GL_i O_i GR_i |AC_i> per site: invariant under the scale and
    phase of the environments once <C|GL GR|C> = 1."""
    out = []
    for i in range(psi.period):
        AC = psi.AC[i]
        y = ac_apply(GLs[i], Os[i], GRs[i], AC)
        out.append(complex((AC.conj() * y).sum()))
    return np.array(out)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX random complex128 InfiniteMPS (cell 1, D=8) and the critical
    Ising MPO stacked on its device."""
    pj = JInfiniteMPS.random(jax.random.PRNGKey(0), 1, 2, 8)
    Oj = jmod.classical_ising()
    Osj = jnp.stack([Oj.site(0)]).astype(pj.dtype)
    return pj, Oj, Osj


@pytest.mark.parametrize("name", ["classical_ising", "classical_ising_b12",
                                  "finite_classical_ising", "sixvertex",
                                  "hard_hexagon"])
def test_models_match_jax_exactly(name):
    args = {"classical_ising": ("classical_ising", ()),
            "classical_ising_b12": ("classical_ising", (1.2,)),
            "finite_classical_ising": ("finite_classical_ising", (5,)),
            "sixvertex": ("sixvertex", (1.0, 0.7, 1.3)),
            "hard_hexagon": ("hard_hexagon", ())}[name]
    Ot = getattr(tmod, args[0])(*args[1])
    Oj = getattr(jmod, args[0])(*args[1])
    assert Ot.period == Oj.period
    for i in range(Ot.period):
        assert isinstance(Ot.site(i), np.ndarray)
        np.testing.assert_array_equal(Ot.site(i), np.asarray(Oj.site(i)))
        assert Ot.site(i).dtype == np.asarray(Oj.site(i)).dtype


def test_small_eig_dominant_is_exact_and_keeps_the_real_pair_fallback():
    """The dominant Ritz pair is LAPACK's; a real matrix whose top Ritz
    value is a complex pair keeps the JAX power iteration."""
    rng = np.random.default_rng(0)
    H = rng.uniform(size=(12, 12))
    theta, z = tarn.small_eig_dominant(H, 9)
    w, V = np.linalg.eig(H[:9, :9])
    k = np.argmax(np.abs(w))
    assert isinstance(theta, float) or np.isrealobj(theta)
    assert abs(theta - w[k].real) <= 1e-12
    assert np.all(z[9:] == 0) and abs(np.linalg.norm(z) - 1) <= 1e-14
    np.testing.assert_allclose(H[:9, :9] @ z[:9], theta * z[:9], atol=1e-12)
    assert np.vdot(1.0 + 0.1 * np.arange(9), z[:9]) > 0
    # a rotation block on top: the dominant pair is complex
    R = np.diag([0.5, 0.4, 0.3, 0.2])
    R[:2, :2] = 2.0 * np.array([[np.cos(1.0), -np.sin(1.0)],
                                [np.sin(1.0), np.cos(1.0)]])
    theta_t, z_t = tarn.small_eig_dominant(R, 4)
    theta_j, z_j = jarn.small_eig_dominant(jnp.asarray(R), 4)
    assert abs(theta_t - float(theta_j)) <= 1e-12
    np.testing.assert_allclose(z_t, np.asarray(z_j), atol=1e-12)


def test_small_spectra_and_real_selection_match_jax():
    rng = np.random.default_rng(1)
    n = 24
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    Hm = np.triu(A, -1)
    np.testing.assert_allclose(tarn.hessenberg_spectrum(Hm),
                               np.asarray(jarn.hessenberg_spectrum(
                                   jnp.asarray(Hm))), rtol=0, atol=1e-12)
    v0 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    At, Aj = _t(A), jnp.asarray(A)
    wt, nt = tarn.spectrum_arnoldi(lambda x: At @ x, _t(v0), 20, 4)
    wj, nj = jarn.spectrum_arnoldi(lambda x: Aj @ x, jnp.asarray(v0), 20, 4)
    assert nt == int(nj)
    np.testing.assert_allclose(wt, np.asarray(wj), rtol=0, atol=1e-12)
    # a real operator whose two largest modes are a rotation pair above the
    # real fixed point: the real selection finds the real one
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    Dg = np.diag(np.concatenate([[0.0, 0.0, 1.0],
                                 0.3 * rng.uniform(size=n - 3)]))
    Dg[:2, :2] = 1.2 * np.array([[np.cos(2.1), -np.sin(2.1)],
                                 [np.sin(2.1), np.cos(2.1)]])
    B = Q @ Dg @ Q.T
    u0 = rng.standard_normal(n)
    Bt, Bj = _t(B), jnp.asarray(B)
    rt = tarn.dominant_eigs_real(lambda x: Bt @ x, _t(u0), 12, 40, 1e-12)
    rj = jarn.dominant_eigs_real(lambda x: Bj @ x, jnp.asarray(u0), 12, 40,
                                 1e-12)
    assert rt.converged and bool(rj.converged)
    assert abs(rt.eigenvalue - 1.0) <= 1e-12
    assert abs(rt.eigenvalue - float(rj.eigenvalue)) <= 1e-12
    xt, xj = _np(rt.eigenvector), np.asarray(rj.eigenvector)
    np.testing.assert_allclose(xt * np.sign(xt @ xj), xj, atol=1e-10)


@pytest.mark.parametrize("case", ["degenerate", "unique"])
def test_uniqueness_warning_matches_jax(case, caplog):
    """A true two-fold dominant eigenvalue (two Krylov runs from the sin
    seeds agree on it but not on the vector) is reported by both packages;
    a gapped one by neither."""
    rng = np.random.default_rng(2)
    n = 16
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([[1.0, 1.0 if case == "degenerate" else 0.6],
                          0.4 * rng.uniform(size=n - 2)])
    A = Q @ np.diag(lam) @ Q.T
    x = rng.standard_normal(n)
    At, Aj = _t(A), jnp.asarray(A)
    # the JAX package's seeds: the same numbers
    np.testing.assert_array_equal(_np(tfp._pseudo_seed(_t(x), 0.7)),
                                  np.asarray(jfp._pseudo_seed(
                                      jnp.asarray(x), 0.7)))
    with caplog.at_level(logging.WARNING, logger="mpskit_tpu_torch"):
        flag_t = tfp.uniqueness_warning(lambda v: At @ v, _t(x), m=10)
    flag_j = jfp.uniqueness_warning(lambda v: Aj @ v, jnp.asarray(x), m=10)
    assert flag_t == flag_j == (case == "degenerate")
    warned = any("non-unique fixed point" in r.getMessage()
                 for r in caplog.records if r.name == "mpskit_tpu_torch")
    assert warned == flag_t
    val, vec = tfp.fixedpoint(lambda v: At @ v, _t(x), "LM", m=10,
                              check_unique=False)
    assert abs(val - 1.0) <= 1e-10


@pytest.mark.parametrize("cell,mixed", [(1, False), (2, False), (2, True)])
def test_mpo_environments_match_jax(cell, mixed):
    """The dominant channel eigenvalue, the bond pairings <C|GL GR|C> = 1
    and the local Rayleigh quotients, one- and two-site cells; the mixed
    case's bra is the ket perturbed by 5 % (a random bra leaves the mixed
    channel's top eigenvalues too close for the JAX power iteration)."""
    from mpskit_tpu.algorithms.derivatives import ac_apply as jac
    from mpskit_tpu_torch.algorithms.derivatives import ac_apply as tac

    pj = JInfiniteMPS.random(jax.random.PRNGKey(cell), cell, 2, 6)
    noise = jax.random.normal(jax.random.PRNGKey(9), pj.AL.shape)
    bj = JInfiniteMPS.from_A(pj.AL + 0.05 * noise) if mixed else pj
    Oj = jmod.sixvertex(1.0, 0.7, 1.3) if cell == 2 else jmod.classical_ising()
    pt, bt = _carry(pj), _carry(bj)
    Ot = dense_mpo_from_numpy([np.asarray(o) for o in Oj.Os])
    ej = jimpo.mpo_environments(pj, Oj, psi_bra=bj)
    et = timpo.mpo_environments(pt, Ot, psi_bra=bt)
    # both solves stop at a relative residual of 1e-12; the mixed channel's
    # eigenvalue lands 3.6e-12 apart (the JAX Ritz vector is the power
    # iteration's, not the exact one)
    tol = 1e-11 if mixed else 1e-12
    assert abs(et.lambda_cell - complex(ej.lambda_cell)) <= tol * abs(
        et.lambda_cell)
    assert et.resid <= 1e-10
    GL_next = torch.roll(et.GLs, -1, dims=0)
    for i in range(cell):
        v = torch.einsum("axy,yn,arn,xr->", GL_next[i], pt.C[i], et.GRs[i],
                         bt.C[i].conj())
        assert abs(complex(v) - 1) <= 1e-12
    if not mixed:
        Ost = timpo.stack_O(Ot, cell, pt.dtype, "cpu")
        Osj = jnp.stack([Oj.site(i) for i in range(cell)]).astype(pj.dtype)
        np.testing.assert_allclose(
            _local_lams(pt, Ost, et.GLs, et.GRs, tac),
            _local_lams(pj, Osj, ej.GLs, ej.GRs, jac), rtol=1e-12)
        lam_t = expectation_value(pt, Ot, envs=et)
        lam_j = complex(jexpval(pj, Oj, envs=ej))
        assert abs(lam_t - lam_j) <= 1e-12
        assert abs(timpo.mpo_transfer_leading(pt, Ot)
                   - et.lambda_cell) <= 1e-12 * abs(et.lambda_cell)


def test_boundary_iterations_match_jax(jax_state, jax_converged_ritz):
    """One boundary VUMPS iteration (and a second from the first one's
    environment guesses), one VOMPS iteration and the free energy and
    gradient, each from one carried state, to 1e-10."""
    pj, Oj, Osj = jax_state
    pt = _carry(pj)
    Ost = timpo.stack_O(classical_ising(), 1, pt.dtype, "cpu")
    out_j = jsm._boundary_vumps_iteration(pj, Osj, 30, 1e-13, 1e-12, 1e-4)
    out_t = tsm._boundary_vumps_iteration(pt, Ost, 30, 1e-13, 1e-12, 1e-4)
    assert abs(float(out_t[1]) - float(out_j[1])) <= 1e-10
    np.testing.assert_allclose(_schmidt(out_t[0].C[0]),
                               _schmidt(out_j[0].C[0]), atol=1e-10)
    out2_j = jsm._boundary_vumps_iteration(out_j[0], Osj, 30, 1e-13, 1e-12,
                                           1e-4, GL_guess=out_j[2],
                                           GR_guess=out_j[3])
    out2_t = tsm._boundary_vumps_iteration(out_t[0], Ost, 30, 1e-13, 1e-12,
                                           1e-4, GL_guess=out_t[2],
                                           GR_guess=out_t[3])
    assert abs(float(out2_t[1]) - float(out2_j[1])) <= 1e-10
    assert out2_t[4][0] == int(out2_j[4][0])

    vj = jsm._boundary_vomps_iteration(pj, Osj, 1e-13, 1e-12)
    vt = tsm._boundary_vomps_iteration(pt, Ost, 1e-13, 1e-12)
    assert abs(float(vt[1]) - float(vj[1])) <= 1e-10
    np.testing.assert_allclose(_schmidt(vt[0].C[0]), _schmidt(vj[0].C[0]),
                               atol=1e-10)

    fj, gj, _, _ = jsm._boundary_value_and_gradient(pj, Osj, 1e-12)
    ft, gt, _, _ = tsm._boundary_value_and_gradient(pt, Ost, 1e-12)
    assert abs(float(ft) - float(fj)) <= 1e-10
    np.testing.assert_allclose(_np(gt), np.asarray(gj), atol=1e-10)
    # the masked branch (the anyonic boundaries' path; AR built locally
    # from (C_{i-1}, AC_i)) with masks that admit everything
    Am, Cm = np.ones(pt.AC.shape, bool), np.ones(pt.C.shape, bool)
    mj = jsm._boundary_vumps_iteration(pj, Osj, 30, 1e-13, 1e-12, 1e-4,
                                       A_mask=jnp.asarray(Am),
                                       C_mask=jnp.asarray(Cm))
    mt = tsm._boundary_vumps_iteration(pt, Ost, 30, 1e-13, 1e-12, 1e-4,
                                       A_mask=torch.as_tensor(Am),
                                       C_mask=torch.as_tensor(Cm))
    assert abs(float(mt[1]) - float(mj[1])) <= 1e-10
    for a, b in zip((mt[0].AR, mt[0].C), (mj[0].AR, mj[0].C)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-10)


def test_grassmann_boundary_matches_jax(jax_state, jax_converged_ritz):
    """Two GradientGrassmann steps of the boundary (the shared QR
    retraction and line search) from one carried state."""
    pj, Oj, Osj = jax_state
    pt = _carry(pj)
    alg_j = jgr.GradientGrassmann(tol=1e-12, maxiter=2, verbosity=0)
    psi_j, envs_j, gn_j = jsm.leading_boundary(pj, Oj, alg_j)
    psi_t, envs_t, gn_t = leading_boundary(
        pt, classical_ising(), GradientGrassmann(tol=1e-12, maxiter=2,
                                                 verbosity=0))
    assert abs(gn_t - gn_j) <= 1e-8 * max(1.0, gn_j)
    assert abs(envs_t.lambda_cell - complex(envs_j.lambda_cell)) <= 1e-10
    np.testing.assert_allclose(_schmidt(psi_t.C[0]), _schmidt(psi_j.C[0]),
                               atol=1e-10)


def test_mpohamiltonian_row_matches_dense(jax_state):
    """An FSM MPOHamiltonian row, block diagonal with the Ising transfer
    matrix on level 0 and a 0.5-scaled copy on level 1, is read through
    its stacked site tensors: one iteration against JAX's, and the same
    dominant channel as the DenseMPO's."""
    pj, Oj, _ = jax_state
    T = np.asarray(Oj.site(0))
    w = T.shape[0]
    W = np.zeros((1, 2 * w, 2 * w, 2, 2), T.dtype)
    W[0, :w, :w] = T
    W[0, w:, w:] = 0.5 * T
    Hj = JMPOHamiltonian.from_dense_W(W)
    Ht = mpo_from_numpy(W)
    pt = _carry(pj)
    Osj = jnp.stack([Hj.site(0)]).astype(pj.dtype)
    Ost = timpo.stack_O(Ht, 1, pt.dtype, "cpu")
    np.testing.assert_array_equal(_np(Ost), np.asarray(Osj))
    out_j = jsm._boundary_vumps_iteration(pj, Osj, 30, 1e-13, 1e-12, 1e-4)
    out_t = tsm._boundary_vumps_iteration(pt, Ost, 30, 1e-13, 1e-12, 1e-4)
    assert abs(float(out_t[1]) - float(out_j[1])) <= 1e-10
    lam_row = timpo.mpo_environments(out_t[0], Ht).lambda_cell
    lam_dense = timpo.mpo_environments(out_t[0], classical_ising()
                                       ).lambda_cell
    assert abs(lam_row - lam_dense) <= 1e-10 * abs(lam_dense)


def test_two_row_multiline_iteration_matches_jax(jax_converged_ritz):
    """One iteration of the two-row boundary (rows coupled r -> r+1) with
    a DenseMPO and an MPOHamiltonian row, from two carried rows."""
    rows_j = tuple(JInfiniteMPS.random(jax.random.PRNGKey(10 + r), 1, 2, 6)
                   for r in range(2))
    Oj = jmod.classical_ising()
    T = np.asarray(Oj.site(0))
    mo_j = JMPOMultiline((Oj, JMPOHamiltonian.from_dense_W(T[None])))
    mo_t = MPOMultiline((classical_ising(), mpo_from_numpy(T[None])))
    psi_j, envs_j, eps_j = jsm.leading_boundary(
        JMPSMultiline(rows_j), mo_j,
        jsm.VUMPS_Boundary(maxiter=1, krylovdim=20, verbosity=0))
    psi_t, envs_t, eps_t = leading_boundary(
        MPSMultiline(tuple(_carry(p) for p in rows_j)), mo_t,
        VUMPS_Boundary(maxiter=1, krylovdim=20, verbosity=0))
    assert isinstance(psi_t, MPSMultiline) and psi_t.nrows == 2
    assert abs(eps_t - eps_j) <= 1e-10
    for r in range(2):
        # a mixed channel's eigenvalue carries the relative phase of two
        # rows, each gauge-fixed on its own: compare magnitudes
        assert abs(abs(envs_t[r].lambda_cell)
                   - abs(complex(envs_j[r].lambda_cell))) <= 1e-10
        np.testing.assert_allclose(_schmidt(psi_t.rows[r].C[0]),
                                   _schmidt(psi_j.rows[r].C[0]), atol=1e-10)


def test_leading_boundary_vomps_matches_jax(jax_state, jax_converged_ritz):
    pj, Oj, _ = jax_state
    psi_j, envs_j, eps_j = jsm.leading_boundary(
        pj, Oj, jsm.VOMPS(tol=1e-14, maxiter=3, verbosity=0))
    psi_t, envs_t, eps_t = leading_boundary(
        _carry(pj), classical_ising(), VOMPS(tol=1e-14, maxiter=3,
                                             verbosity=0))
    assert abs(eps_t - float(eps_j)) <= 1e-10
    assert abs(envs_t.lambda_cell - complex(envs_j.lambda_cell)) <= 1e-10


def test_exact_ritz_boundary_converges_at_criticality():
    """The deliberate difference (ROADMAP.md): with the dominant Ritz pair
    solved exactly, boundary VUMPS on the critical Ising MPO at D=12
    converges, and its leading eigenvalue lands within 1e-7 (relative) of
    Onsager's. The JAX package's fixed 300-step power iteration leaves the
    same run wandering (ROADMAP.md, known reference-side defects)."""
    gen = torch.Generator().manual_seed(0)
    psi = InfiniteMPS.random(1, 2, 12, torch.complex128, "cpu", gen)
    O = classical_ising()
    psi, envs, eps = leading_boundary(psi, O, VUMPS_Boundary(
        tol=1e-8, maxiter=60, verbosity=0))
    lam = expectation_value(psi, O, envs=envs)
    assert eps < 1e-5
    assert abs(lam - ONSAGER) / ONSAGER <= 1e-7
    assert abs(lam.imag) <= 1e-12
