"""The measurement toolbox of the PyTorch port (transfer spectra, variance,
the Galerkin residual, entropy profiles, exact diagonalization, the
fidelity susceptibility) and the small solvers it brings (conjugate
gradient, the Lanczos ground state, the tridiagonal Ritz solve,
`isometry`) against the JAX package on the CPU; and the measurement slice
as a whole at a small size: the three legs of chip_smoke.py's phase 17
through both packages.

States are made by the JAX package from a PRNGKey (or by both packages'
solvers from the same carried start) and carried across with `interop`;
operators and vectors are numpy arrays from a seed. Values are compared
in float64 / complex128 to the tolerance each test states: rounding
(1e-12 to 1e-10) where both packages compute the same numbers, the
solver tolerance where each runs its own Krylov solve."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import correlators as jcor
from mpskit_tpu.algorithms import toolbox as jtb
from mpskit_tpu.algorithms.dmrg import DMRG as JDMRG
from mpskit_tpu.algorithms.expval import expectation_value as jexpval
from mpskit_tpu.algorithms.find_groundstate import find_groundstate as jfind
from mpskit_tpu.environments import infinite_ham as jinf
from mpskit_tpu.linalg import gmres as jgm
from mpskit_tpu.linalg import lanczos as jla
from mpskit_tpu.models import fermions as jf
from mpskit_tpu.models import hamiltonians as jh
from mpskit_tpu.operators.mpo import DenseMPO as JDenseMPO
from mpskit_tpu.operators.mpo import MPOHamiltonian as JMPOHamiltonian
from mpskit_tpu.states import quasiparticle as jqp
from mpskit_tpu.states.finitemps import FiniteMPS as JFiniteMPS
from mpskit_tpu.states.infinitemps import InfiniteMPS as JInfiniteMPS
from mpskit_tpu.tensors import ops as jops
from mpskit_tpu_torch import (
    DMRG, VUMPS, DenseMPO, InfiniteMPS, MPOHamiltonian, calc_galerkin,
    correlation_length, correlator, entropy_profile, exact_diagonalization,
    expectation_value, fidelity_susceptibility, find_groundstate, isometry,
    lanczos_groundstate, linsolve_cg, marek_gap, string_correlator,
    transfer_spectrum, variance,
)
from mpskit_tpu_torch.interop import (
    finite_mps_from_numpy, finite_qp_from_numpy, infinite_mps_from_numpy,
    mpo_from_numpy,
)
from mpskit_tpu_torch.linalg import lanczos as tla
from mpskit_tpu_torch.models import fermions as tf
from mpskit_tpu_torch.models import hamiltonians as th

torch.set_num_threads(1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol)


def _carry_finite(pj):
    return finite_mps_from_numpy(np.asarray(pj.ALs), np.asarray(pj.ARs),
                                 np.asarray(pj.AC), pj.center, device="cpu")


def _carry_infinite(pj):
    return infinite_mps_from_numpy(*(np.asarray(x) for x in
                                     (pj.AL, pj.AR, pj.AC, pj.C)), "cpu")


def _infinite(L=2, d=2, D=5, seed=1, dtype=jnp.complex128):
    pj = JInfiniteMPS.random(jax.random.PRNGKey(seed), L, d, D, dtype=dtype)
    return pj, _carry_infinite(pj)


def _finite(L=6, d=2, D=6, seed=0, dtype=jnp.complex128):
    pj = JFiniteMPS.random(jax.random.PRNGKey(seed), L, d, D, dtype=dtype)
    return pj, _carry_finite(pj)


def test_transfer_spectrum_marek_gap_and_correlation_length():
    """A random complex period-2 cell at D=5: the sorted magnitudes of the
    five leading transfer eigenvalues (|lambda_1| = 1), eps, delta and
    xi agree with the JAX package to 1e-12; sector= on a plain state
    raises ValueError, as in the JAX package."""
    pj, pt = _infinite()
    lj = np.sort(np.abs(np.asarray(jtb.transfer_spectrum(pj))))
    lt = transfer_spectrum(pt)
    assert lt.device.type == "cpu" and lt.shape == (5,)
    _close(np.sort(np.abs(_np(lt))), lj, 1e-12)
    assert abs(lj[-1] - 1) <= 1e-12
    _close(np.array(marek_gap(pt)),
           np.array([float(x) for x in jtb.marek_gap(pj)]), 1e-12)
    assert abs(correlation_length(pt)
               - float(jtb.correlation_length(pj))) <= 1e-11
    with pytest.raises(ValueError, match="SymmetricInfiniteMPS"):
        transfer_spectrum(pt, sector=1)


@pytest.mark.parametrize("kind", ["finite", "infinite", "finite_qp"])
def test_variance(kind):
    """<H^2> - <H>^2 of a random finite state (XXZ spin-1/2, L=6), the
    two-site tangent variance of a random period-2 infinite state (TFIM),
    and the variance of a FiniteQP (made by the JAX package, embedded as
    a FiniteMPS): the JAX values to 1e-10."""
    if kind == "infinite":
        pj, pt = _infinite()
        Hj = jh.transverse_field_ising(g=1.3, period=2)
        _close(variance(pt, mpo_from_numpy(np.asarray(Hj.W))),
               jtb.variance(pj, Hj), 1e-10)
        return
    pj, pt = _finite()
    Hj = jh.heisenberg_XXZ(spin=0.5, delta=0.6)
    Ht = th.heisenberg_XXZ(spin=0.5, delta=0.6)
    if kind == "finite":
        _close(variance(pt, Ht), jtb.variance(pj, Hj), 1e-10)
        return
    qj = jqp.FiniteQP.random(jax.random.PRNGKey(3), pj)
    qt = finite_qp_from_numpy(*(np.asarray(a) for a in
                                (qj.Xs, qj.VLs, qj.ALs, qj.ARs, qj.mask)),
                              device="cpu")
    _close(variance(qt, Ht), jtb.variance(qj, Hj), 1e-10)


def test_calc_galerkin_and_entropy_profile():
    """The Galerkin residual of a random finite state (center 0 and 3)
    and of a random infinite cell, and the entropy at every bond of the
    finite state: the JAX values to 1e-12."""
    pj, pt = _finite()
    Hj = jh.heisenberg_XXZ(spin=0.5, delta=0.6)
    Ht = th.heisenberg_XXZ(spin=0.5, delta=0.6)
    for c in (0, 3):
        _close(calc_galerkin(pt.move_center(c), Ht),
               jtb.calc_galerkin(pj.move_center(c), Hj), 1e-12)
    _close(entropy_profile(pt), jtb.entropy_profile(pj), 1e-12)
    ij, it = _infinite()
    Hi = jh.transverse_field_ising(g=1.3, period=2)
    _close(calc_galerkin(it, mpo_from_numpy(np.asarray(Hi.W))),
           jtb.calc_galerkin(ij, Hi), 1e-12)


def test_exact_diagonalization():
    """The three lowest levels of the TFIM (g=1.5) and of spin-1/2 XXZ on
    L=6: JAX's and the dense spectrum's to 1e-9 (Lanczos tolerance
    1e-12), the states normalized and on the CPU when asked."""
    for Hj, Ht in ((jh.transverse_field_ising_lattice(g=1.5),
                    th.transverse_field_ising_lattice(g=1.5)),
                   (jh.heisenberg_XXZ(spin=0.5, delta=0.4),
                    th.heisenberg_XXZ(spin=0.5, delta=0.4))):
        ej, _ = jtb.exact_diagonalization(Hj, 6, num=3)
        et, states = exact_diagonalization(Ht, 6, num=3, device="cpu")
        assert et.device.type == "cpu" and et.dtype == torch.float64
        ev = np.linalg.eigvalsh(Ht.to_matrix(6))[:3]
        _close(et, np.asarray(ej), 1e-9)
        _close(et, ev, 1e-9)
        for s in states:
            assert s.device.type == "cpu"
            assert abs(float(s.norm()) - 1) <= 1e-12


def _perturbations():
    """The transverse field -sum X and the bond -sum X X."""
    X = np.array([[0, 1], [1, 0.0]], complex)
    return [-X, -np.kron(X, X).reshape(2, 2, 2, 2)]


@functools.lru_cache(maxsize=None)
def _fidelity_case():
    """A TFIM (g=1.5) ground state at D=4 by the port's VUMPS from a
    seeded start, carried to the JAX package, and the JAX package's
    fidelity susceptibility under the transverse field (one run, shared
    by the tests below: each JAX CG solve takes ~15 s here)."""
    Ht = th.transverse_field_ising_lattice(g=1.5)
    pt = InfiniteMPS.random(1, 2, 4, torch.complex128, "cpu",
                            torch.Generator().manual_seed(2))
    pt, _, _ = find_groundstate(pt, Ht, VUMPS(tol=1e-10, maxiter=100))
    pj = JInfiniteMPS(*(jnp.asarray(_np(x)) for x in (pt.AL, pt.AR, pt.AC,
                                                        pt.C)))
    Hj = jh.transverse_field_ising_lattice(g=1.5)
    Gj = np.asarray(jtb.fidelity_susceptibility(
        pj, Hj, [JMPOHamiltonian.from_local(_perturbations()[0])]))
    return Ht, pt, Gj


def test_fidelity_susceptibility():
    """The Gram matrix of the TFIM (g=1.5, D=4) ground state under the
    transverse field, the X X bond and their sum: the transverse-field
    entry equals the JAX value to 1e-9 relative (both CG solves stop at
    1e-8 from the same zero start on operators that agree to rounding;
    the tangent bases differ by a unitary, which the Gram matrix does not
    see) and the exact per-site value 1 / (16 g^2 (g^2 - 1)) of the
    infinite chain to 1e-4 (D=4); the matrix is Hermitian and positive
    semidefinite, and linear in the perturbation (the sum's entry is
    G00 + G11 + 2 Re G01, to 1e-9 relative)."""
    Ht, pt, Gj = _fidelity_case()
    Vs = [MPOHamiltonian.from_local(V) for V in _perturbations()]
    Vs.append(MPOHamiltonian.from_local(_perturbations()[0])
              + MPOHamiltonian.from_local(_perturbations()[1]))
    G = _np(fidelity_susceptibility(pt, Ht, Vs))
    assert G.shape == (3, 3)
    _close(G[:1, :1], Gj, 1e-9 * abs(Gj[0, 0]))
    _close(G, G.conj().T, 1e-14)
    assert np.linalg.eigvalsh(G[:2, :2]).min() > 0
    assert np.linalg.eigvalsh(G).min() > -1e-12
    assert abs(G[2, 2] - (G[0, 0] + G[1, 1] + 2 * G[0, 1].real)) \
        <= 1e-9 * abs(G[2, 2])
    assert abs(G[0, 0].real - 1 / (16 * 1.5 ** 2 * (1.5 ** 2 - 1))) <= 1e-4


@pytest.mark.parametrize("as_list", [False, True])
def test_linsolve_cg(as_list):
    """CG on a random SPD matrix (n=30, condition ~ 50): the JAX solution
    to 1e-11, the residual below the stopping rule, the same solution
    for a tensor and for a list of two tensors."""
    rng = np.random.default_rng(11)
    A = rng.standard_normal((30, 30))
    A = A @ A.T / 30 + 0.05 * np.eye(30)
    b = rng.standard_normal(30)
    xj = np.asarray(jgm.linsolve_cg(lambda x: jnp.asarray(A) @ x,
                                    jnp.asarray(b), tol=1e-12))
    At = torch.from_numpy(A)
    if as_list:
        def mv(x):
            y = At @ torch.cat(x)
            return [y[:10], y[10:]]
        x = torch.cat(linsolve_cg(mv, [torch.from_numpy(b[:10]),
                                       torch.from_numpy(b[10:])], tol=1e-12))
    else:
        x = linsolve_cg(lambda v: At @ v, torch.from_numpy(b), tol=1e-12)
    _close(x, xj, 1e-11)
    assert np.linalg.norm(A @ _np(x) - b) <= 1e-12 * np.linalg.norm(b)


def test_lanczos_groundstate():
    """The smallest eigenpair of a random real symmetric matrix (n=60):
    the JAX eigenvalue and the dense one to 1e-10, the eigenvector up to
    sign to 1e-8."""
    rng = np.random.default_rng(12)
    M = rng.standard_normal((60, 60))
    M = (M + M.T) / 2
    v0 = rng.standard_normal(60)
    lj, xj = jla.lanczos_groundstate(lambda v: jnp.asarray(M) @ v,
                                     jnp.asarray(v0), m=20, tol=1e-12)
    lt, xt = lanczos_groundstate(lambda v: torch.from_numpy(M) @ v,
                                 torch.from_numpy(v0), m=20, tol=1e-12)
    w, V = np.linalg.eigh(M)
    assert abs(lt - float(lj)) <= 1e-10 and abs(lt - w[0]) <= 1e-10
    xt, xj = _np(xt), np.asarray(xj)
    _close(xt * np.sign(xt @ xj), xj, 1e-8)


@pytest.mark.parametrize("nvalid", [10, 7, 3, 1])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tridiag_smallest(nvalid, dtype):
    """The masked tridiagonal Ritz solve: eigenvalue and eigenvector equal
    JAX's Sturm-bisection result to 1e-12 in float64 (to 1e-5 in float32,
    JAX's float32 bisection), zero on the invalid slots, the sign JAX's
    inverse iteration gives."""
    rng = np.random.default_rng(13 + nvalid)
    a = rng.standard_normal(10).astype(dtype)
    b = np.abs(rng.standard_normal(10)).astype(dtype)
    lj, sj = jla.tridiag_smallest(jnp.asarray(a), jnp.asarray(b), nvalid, 10)
    lt, st = tla.tridiag_smallest(torch.from_numpy(a), torch.from_numpy(b),
                                  nvalid, 10)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert st.dtype == torch.from_numpy(a).dtype
    assert abs(lt - float(lj)) <= tol
    _close(st, np.asarray(sj), tol)
    assert np.all(_np(st)[nvalid:] == 0)


def test_isometry():
    for m, n in ((5, 3), (4, 4)):
        Vj = np.asarray(jops.isometry(m, n))
        Vt = isometry(m, n, device="cpu")
        assert Vt.dtype == torch.complex128 and np.array_equal(_np(Vt), Vj)
    assert isometry(3, 2, torch.float64, "cpu").dtype == torch.float64


# the JAX environments under one jit: compiled once per shape
_jax_envs = jax.jit(jinf.hamiltonian_environments)


# ----------------------------------------------------------------------------
# the measurement slice as a whole: phase 17's three legs at a small size
# ----------------------------------------------------------------------------

def _leg_free_fermions():
    """Free fermions L=10 at D=16 (a truncation of the exact D=32 state):
    one-site DMRG in both packages from the same carried float64 start,
    then every measurement of leg (a) through both packages. The two
    solves agree to their tolerance: energies to 1e-10, the
    measurements to 1e-7, each against the other; the energy within 1e-5
    and the correlators within 1e-3 of the exact free-fermion values
    (D=16 truncates)."""
    L, D = 10, 16
    Hj, Ht = jf.free_fermions(), tf.free_fermions()
    pj = JFiniteMPS.random(jax.random.PRNGKey(4), L, 2, D, dtype=jnp.float64)
    pt = _carry_finite(pj)
    pj, envj, _ = jfind(pj, Hj, JDMRG(tol=1e-10, maxiter=20))
    pt, envt, _ = find_groundstate(pt, Ht, DMRG(tol=1e-10, maxiter=20))
    Ej = float(jexpval(pj, Hj, envs=envj))
    Et = float(expectation_value(pt, Ht, envs=envt))
    exact = tf.kitaev_bdg_energy(L, 1.0, 0.0, 0.0)
    assert abs(Et - Ej) <= 1e-10 and abs(Et - exact) <= 1e-5
    c = np.array([[0, 1], [0, 0.0]])
    Z = np.diag([1.0, -1.0])
    n = c.T @ c
    js = list(range(3, L))
    hop = np.einsum("st,uv->sutv", c.T @ Z, c) + \
        np.einsum("st,uv->sutv", Z @ c, c.T)
    par_j = JDenseMPO.from_array(jnp.asarray(Z)[None, None], period=L)
    pairs = [
        (entropy_profile(pt), jtb.entropy_profile(pj)),
        (string_correlator(pt, c.T @ Z, Z, c, 2, js),
         jcor.string_correlator(pj, c.T @ Z, Z, c, 2, js)),
        (correlator(pt, n, n, 2, js), jcor.correlator(pj, n, n, 2, js)),
        (expectation_value(pt, (4, hop)), jexpval(pj, (4, hop))),
        (expectation_value(pt, DenseMPO.from_array(Z[None, None], period=L)),
         jexpval(pj, par_j)),
        (variance(pt, Ht), jtb.variance(pj, Hj)),
    ]
    for a, b in pairs:
        _close(a, b, 1e-7)
    h = -(np.eye(L, k=1) + np.eye(L, k=-1))
    e, U = np.linalg.eigh(h)
    C = U[:, e < 0] @ U[:, e < 0].T
    _close(pairs[1][0], C[2, js], 1e-3)
    assert abs(complex(pairs[4][0]) - (-1) ** (L // 2)) <= 1e-6


def _leg_hubbard():
    """The half-filled Hubbard chain (U=4, mu=2) on a two-site cell at
    D=8: 30 VUMPS iterations in the port from a seeded random state,
    carried to the JAX package; every measurement of leg (b) through both
    packages on that state (the JAX side with its environments solved
    once), to 1e-10 (the spectrum by sorted magnitudes); the cell-mean
    energy within 1e-2 of Lieb-Wu's (D=8)."""
    Hj = jf.hubbard(t=1.0, U=4.0, mu=2.0, period=2)
    Ht = tf.hubbard(t=1.0, U=4.0, mu=2.0, period=2)
    assert np.array_equal(np.asarray(Hj.W), Ht.W)
    pt = InfiniteMPS.random(2, 4, 8, torch.float64, "cpu",
                            torch.Generator().manual_seed(5))
    pt, envt, _ = find_groundstate(pt, Ht, VUMPS(tol=1e-8, maxiter=30))
    pj = JInfiniteMPS(*(jnp.asarray(_np(x)) for x in (pt.AL, pt.AR, pt.AC,
                                                        pt.C)))
    envj = _jax_envs(pj, Hj)
    _, _, n_up, n_dn, _ = tf._spinful_ops()
    nt = n_up + n_dn
    e = float(expectation_value(pt, Ht, envs=envt).mean())
    assert abs(e - (-2.5737293678984039)) <= 1e-2
    _close(np.sort(np.abs(_np(transfer_spectrum(pt)))),
           np.sort(np.abs(np.asarray(jtb.transfer_spectrum(pj)))), 1e-10)
    _close(np.array(marek_gap(pt)),
           np.array([float(x) for x in jtb.marek_gap(pj)]), 1e-10)
    assert abs(correlation_length(pt)
               - float(jtb.correlation_length(pj))) <= 1e-9
    pairs = [
        (expectation_value(pt, Ht, envs=envt), jexpval(pj, Hj, envs=envj)),
        (variance(pt, Ht, envs=envt), jtb.variance(pj, Hj, envs=envj)),
        (calc_galerkin(pt, Ht, envs=envt), jtb.calc_galerkin(pj, Hj,
                                                             envs=envj)),
        (expectation_value(pt, Ht, range(0, 8), envs=envt),
         jexpval(pj, Hj, range(0, 8), envs=envj)),
        (expectation_value(pt, Ht, 16, envs=envt),
         jexpval(pj, Hj, 16, envs=envj)),
        (expectation_value(pt, (1, nt)), jexpval(pj, (1, nt))),
        (correlator(pt, nt, nt, 0, [40]), jcor.correlator(pj, nt, nt, 0,
                                                         [40])),
    ]
    for a, b in pairs:
        _close(a, b, 1e-10)


def _leg_ed_and_fidelity():
    """ED of the TFIM (g=1.5) on L=8 in both packages, num=2: against each
    other and the free-fermion E0 and E1 = E0 + 2 sigma_min to 1e-9; the
    fidelity susceptibility of a D=4 infinite ground state under the
    transverse field in both packages to 1e-9 relative."""
    L, g = 8, 1.5
    Hj = jh.transverse_field_ising_lattice(g=g)
    Ht = th.transverse_field_ising_lattice(g=g)
    ej, _ = jtb.exact_diagonalization(Hj, L, num=2)
    et, _ = exact_diagonalization(Ht, L, num=2, device="cpu")
    sigma = np.linalg.svd(g * np.eye(L) + np.eye(L, k=1), compute_uv=False)
    e0 = -sigma.sum()
    _close(et, np.asarray(ej), 1e-9)
    _close(et, [e0, e0 + 2 * sigma.min()], 1e-9)
    Hf, pt, Gj = _fidelity_case()
    Gt = _np(fidelity_susceptibility(
        pt, Hf, [MPOHamiltonian.from_local(_perturbations()[0])]))
    _close(Gt, Gj, 1e-9 * abs(Gj[0, 0]))


@pytest.mark.parametrize("leg", ["free_fermions", "hubbard",
                                 "ed_and_fidelity"])
def test_measurement_slice_through_both_packages(leg):
    {"free_fermions": _leg_free_fermions, "hubbard": _leg_hubbard,
     "ed_and_fidelity": _leg_ed_and_fidelity}[leg]()
