"""The two-site slice of the PyTorch port against the JAX package and
against exact energies: the truncated SVD and the null spaces, one
two-site DMRG sweep, two-site DMRG to convergence, and one IDMRG1 and
IDMRG2 iteration.

Inputs are made with numpy from a seed, or by the JAX package and carried
across with `interop`, and fed to both packages in float64 / complex128.
SVD vectors carry a sign or phase per singular value and null-space bases
are not unique, so the tests compare what is invariant: energies, Schmidt
values, discarded weights, overlaps, the products U S Vh and the
projectors VL VL^dag. QR with a positive diagonal is unique, so the IDMRG1
environments and bond matrices are compared elementwise."""

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import dmrg2 as jdmrg2
from mpskit_tpu.algorithms import idmrg as jidmrg
from mpskit_tpu.algorithms import toolbox as jtool
from mpskit_tpu.environments import finite as jenv
from mpskit_tpu.environments import infinite_ham as jinf
from mpskit_tpu.models import hamiltonians as jham
from mpskit_tpu.states import finitemps as jmps
from mpskit_tpu.states import infinitemps as jimps
from mpskit_tpu.tensors import ops as jops
from mpskit_tpu_torch import (
    DMRG2, IDMRG1, IDMRG2, FiniteMPS, InfiniteMPS, entanglement_spectrum,
    entropy, expectation_value, find_groundstate, heisenberg_XXX,
    transverse_field_ising, transverse_field_ising_lattice,
)
from mpskit_tpu_torch.algorithms.dmrg2 import (
    _dmrg2_sweep_impl, bond_support_vectors,
)
from mpskit_tpu_torch.algorithms.idmrg import (
    _idmrg1_iteration, _idmrg2_iteration,
)
from mpskit_tpu_torch.config import matmul_precision
from mpskit_tpu_torch.environments.finite import (
    compute_right_envs, right_boundary, stack_W,
)
from mpskit_tpu_torch.interop import (
    finite_mps_from_numpy, infinite_mps_from_numpy, mpo_from_numpy,
)
from mpskit_tpu_torch.tensors import ops as tops

torch.set_num_threads(1)

G = 1.5
# -(1/pi) int_0^pi sqrt(1 + g^2 - 2 g cos k) dk at g = 1.5 (Gauss-Legendre)
_k, _wk = np.polynomial.legendre.leggauss(200)
TFIM_E0 = float(-np.sum(_wk * np.sqrt(1 + G * G - 2 * G * np.cos(
    np.pi * (_k + 1) / 2))) / 2)

# the JAX sweep without buffer donation, so its inputs stay readable
_jax_sweep2 = partial(jax.jit, static_argnums=(6, 7, 8))(
    jdmrg2._dmrg2_sweep_impl)

SCHEMES = {
    "notrunc": tops.notrunc(),
    "truncdim": tops.truncdim(3),
    "truncerr": tops.truncerr(2e-2),
    "truncbelow": tops.truncbelow(5e-3),
    "combined": tops.TruncationScheme(dim=4, err=1e-3, below=1e-9),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _jscheme(s):
    return jops.TruncationScheme(dim=s.dim, err=s.err, below=s.below)


def _padded_rank_deficient(dtype):
    """A (12, 10) matrix whose only nonzero block is (6, 5) of rank 5, with
    graded singular values 1 .. 1e-3: the shape of a padded theta at a
    chain's edge."""
    rng = np.random.default_rng(0)
    M = np.zeros((12, 10), dtype)
    U = np.linalg.qr(rng.standard_normal((6, 5)))[0]
    V = np.linalg.qr(rng.standard_normal((5, 5)))[0]
    if np.issubdtype(dtype, np.complexfloating):
        U = U * np.exp(1j * rng.uniform(0, 2 * np.pi, 5))
    M[:6, :5] = (U * np.array([1.0, 0.5, 0.1, 1e-2, 1e-3])) @ V.T
    return M


@pytest.mark.parametrize("Dmax", [4, 12])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_svd_truncated_matches_jax(scheme, Dmax):
    """S and err to 1e-12 and U diag(S) Vh to 1e-12, cut (Dmax 4 < rank
    10) and zero-padded (Dmax 12 > min(m, n))."""
    for dtype in (np.float64, np.complex128):
        M = _padded_rank_deficient(dtype)
        U, S, Vh, err = tops.svd_truncated(_t(M), Dmax, SCHEMES[scheme])
        Uj, Sj, Vhj, errj = jops.svd_truncated(jnp.asarray(M), Dmax,
                                               _jscheme(SCHEMES[scheme]))
        assert U.shape == (12, Dmax) and Vh.shape == (Dmax, 10)
        np.testing.assert_allclose(_np(S), np.asarray(Sj), rtol=0, atol=1e-12)
        assert abs(float(err) - float(errj)) <= 1e-12
        np.testing.assert_allclose(
            _np(U * S.to(U.dtype)) @ _np(Vh),
            np.asarray(Uj * Sj.astype(Uj.dtype)) @ np.asarray(Vhj), rtol=0,
            atol=1e-12)
        # the columns are orthonormal or zero, and zero where S was cut
        gram = _np(U).conj().T @ _np(U)
        live = np.round(np.diag(gram).real)
        np.testing.assert_allclose(gram, np.diag(live), rtol=0, atol=1e-12)
        assert np.all(live >= (_np(S) > 0))


def _graded(m, n, s, seed):
    """An (m, n) matrix with singular values s between random orthonormal
    factors."""
    rng = np.random.default_rng(seed)
    k = len(s)
    U = np.linalg.qr(rng.standard_normal((m, k)))[0]
    V = np.linalg.qr(rng.standard_normal((n, k)))[0]
    return (U * s) @ V.T


# two-fold multiplets split by 1e-3 of themselves, as the Schmidt values of
# the Haldane chain nearly are: pair j at 10^(-4 j / 16)
_PAIRS = np.repeat(10.0 ** (-4.0 * np.arange(16) / 16), 2) * np.tile(
    [1.0, 1.0 - 1e-3], 16)

GRAM_CASES = {
    # name: (matrix, kept columns)
    "square": (lambda: _graded(40, 40, np.logspace(0, -6, 40), 2), 24),
    "tall": (lambda: _graded(48, 30, np.logspace(0, -6, 30), 3), 20),
    "wide": (lambda: _graded(30, 48, np.logspace(0, -6, 30), 4), 20),
    "padded": (lambda: _padded_rank_deficient(np.float64), 12),
    "pairs_cut_outside": (lambda: _graded(40, 36, _PAIRS, 5), 20),
    "pairs_cut_inside": (lambda: _graded(40, 36, _PAIRS, 5), 21),
}


@pytest.mark.parametrize("case", list(GRAM_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_svd_via_gram_matches_float64_lapack(dtype, case):
    """The Gram route that `svd_truncated` takes for float32 and complex64
    on the card, run on the CPU, against LAPACK's float64 SVD of the same
    matrix: S and the discarded weight within 1e-5 of S0 = 1, the kept
    U S Vh within 1e-5, every returned column of U and row of Vh
    orthonormal to 1e-5 (those of the exactly zero values of the padded
    matrix too), no NaN. The multiplets are split by 1e-3 of themselves:
    a cut through an exactly degenerate one has no unique U S Vh for any
    SVD."""
    make, k = GRAM_CASES[case]
    M = make()
    if dtype == torch.complex64:
        rng = np.random.default_rng(6)
        M = M * np.exp(1j * rng.uniform(0, 2 * np.pi, M.shape[1]))
    M = torch.from_numpy(M).to(dtype)
    wide = torch.complex128 if dtype == torch.complex64 else torch.float64
    Ur, Sr, Vhr = torch.linalg.svd(M.to(wide), full_matrices=False)
    U, S, Vh, disc = tops._svd_via_gram(M, k)
    kk = min(k, *M.shape)
    assert U.dtype == Vh.dtype == dtype and S.dtype == M.real.dtype
    assert U.shape == (M.shape[0], kk) and Vh.shape == (kk, M.shape[1])
    assert all(torch.isfinite(t).all() for t in (U, S, Vh, disc))
    assert float((S.double() - Sr[:kk]).abs().max()) <= 1e-5
    err = torch.sqrt(disc.double() / (torch.sum(S.double() ** 2) + disc))
    err_ref = torch.sqrt(torch.sum(Sr[kk:] ** 2) / torch.sum(Sr ** 2))
    assert abs(float(err) - float(err_ref)) <= 1e-5
    USV = (U.to(wide) * S.double()) @ Vh.to(wide)
    USV_ref = (Ur[:, :kk] * Sr[:kk]) @ Vhr[:kk]
    assert float((USV - USV_ref).abs().max()) <= 1e-5
    eye = torch.eye(kk, dtype=wide)
    assert float((U.to(wide).mH @ U.to(wide) - eye).abs().max()) <= 1e-5
    assert float((Vh.to(wide) @ Vh.to(wide).mH - eye).abs().max()) <= 1e-5


def test_svd_via_gram_repairs_a_skewed_null_cluster(monkeypatch):
    """An `eigh` whose vectors of the zero eigenvalues (the padded
    matrix's null space) come back 1e-1 from orthonormal, as cuSOLVER's
    `syevd` returned them for a padded DMRG2 theta on an H100: the Gram
    route's Vh rows still orthonormal to 1e-5 and U S Vh unchanged."""
    eigh = torch.linalg.eigh

    def skewed(G):
        lam, V = eigh(G)
        null = int((lam < 1e-12 * lam[-1]).sum())
        mix = torch.eye(null, dtype=V.dtype) + 0.1 * torch.ones(
            null, null, dtype=V.dtype)
        return lam, torch.cat([V[:, :null] @ mix, V[:, null:]], 1)

    M = torch.from_numpy(_padded_rank_deficient(np.float64)).float()
    monkeypatch.setattr(torch.linalg, "eigh", skewed)
    U, S, Vh, _ = tops._svd_via_gram(M, 10)
    Ur, Sr, Vhr = torch.linalg.svd(M.double(), full_matrices=False)
    eye = torch.eye(10, dtype=torch.float64)
    assert float((Vh.double() @ Vh.double().T - eye).abs().max()) <= 1e-5
    assert float((U.double().T @ U.double() - eye).abs().max()) <= 1e-5
    assert float(((U * S) @ Vh - M).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_null_spaces_match_jax(dtype):
    """The projectors VL VL^dag and VR^dag VR against JAX, VL^dag A = 0,
    A VR^dag = 0 and orthonormality, all to 1e-12."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((4, 3, 5)).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        A = A + 1j * rng.standard_normal((4, 3, 5))
    VL, VR = tops.leftnull(_t(A)), tops.rightnull(_t(A))
    VLj, VRj = jops.leftnull(jnp.asarray(A)), jops.rightnull(jnp.asarray(A))
    assert VL.shape == (4, 3, 7) and VR.shape == (11, 3, 5)
    vl, vlj = _np(VL).reshape(12, 7), np.asarray(VLj).reshape(12, 7)
    vr, vrj = _np(VR).reshape(11, 15), np.asarray(VRj).reshape(11, 15)
    np.testing.assert_allclose(vl @ vl.conj().T, vlj @ vlj.conj().T, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(vr.conj().T @ vr, vrj.conj().T @ vrj, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(vl.conj().T @ A.reshape(12, 5), 0, atol=1e-12)
    np.testing.assert_allclose(A.reshape(4, 15) @ vr.conj().T, 0, atol=1e-12)
    np.testing.assert_allclose(vl.conj().T @ vl, np.eye(7), atol=1e-12)
    np.testing.assert_allclose(vr @ vr.conj().T, np.eye(11), atol=1e-12)


def test_safe_xlogx_and_entropy_of_a_product_state():
    x = torch.tensor([0.0, 0.25, 1.0], dtype=torch.float64)
    np.testing.assert_allclose(_np(tops.safe_xlogx(x)),
                               np.asarray(jops.safe_xlogx(_np(x))), atol=0)
    psi = FiniteMPS.random(4, 2, 1, torch.float64, "cpu",
                           torch.Generator().manual_seed(0))
    assert float(entropy(psi, 2)) == 0.0
    assert _np(entanglement_spectrum(psi, 0)).tolist() == [1.0]


def test_ac2_apply_matches_jax():
    """The two-site derivative against JAX (spin-1 shapes: w=5, d=3)."""
    from mpskit_tpu.algorithms import derivatives as jder
    from mpskit_tpu_torch.algorithms import derivatives as tder

    rng = np.random.default_rng(2)
    w, d, D = 5, 3, 6
    args = [rng.standard_normal(sh) for sh in ((w, D, D), (w, w, d, d),
                                               (w, w, d, d), (w, D, D),
                                               (D, d, d, D))]
    np.testing.assert_allclose(
        _np(tder.ac2_apply(*map(_t, args))),
        np.asarray(jder.ac2_apply(*map(jnp.asarray, args))), rtol=0,
        atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_finite_state_helpers_match_jax(dtype):
    """`dot` (also across two bond dimensions), `bond_matrix`,
    `full_gauges` (QR with a positive diagonal: unique, so elementwise)
    and the entanglement spectrum of every bond, against JAX."""
    from mpskit_tpu.states import quasiparticle as jqp
    from mpskit_tpu_torch.states.quasiparticle import full_gauges

    L, d = 6, 2
    key = jax.random.PRNGKey(4)
    pa = jmps.FiniteMPS.random(key, L, d, 8, dtype=dtype)
    pb = jmps.FiniteMPS.random(jax.random.PRNGKey(5), L, d, 4, dtype=dtype)
    ta, tb = (finite_mps_from_numpy(np.asarray(p.ALs), np.asarray(p.ARs),
                                    np.asarray(p.AC), 0, "cpu")
              for p in (pa, pb))
    assert abs(complex(ta.dot(tb)) - complex(pa.dot(pb))) <= 1e-12
    assert abs(complex(ta.dot(ta)) - 1.0) <= 1e-12
    pa3, ta3 = pa.move_center(3), ta.move_center(3)
    np.testing.assert_allclose(_np(ta3.bond_matrix()),
                               np.asarray(pa3.bond_matrix()), rtol=0,
                               atol=1e-12)
    for a, b in zip(full_gauges(ta3), jqp.full_gauges(pa3)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                   atol=1e-12)
    for bond in range(L + 1):
        np.testing.assert_allclose(
            _np(entanglement_spectrum(ta, bond)),
            np.asarray(jtool.entanglement_spectrum(pa, bond)), rtol=0,
            atol=1e-12)
        assert abs(float(entropy(ta, bond))
                   - float(jtool.entropy(pa, bond))) <= 1e-12


def _models(name, dt):
    if name == "tfim":
        Hj = jham.transverse_field_ising_lattice(g=G, dtype=dt)
    else:
        Hj = jham.heisenberg_XXX(spin=1)
    return mpo_from_numpy(np.asarray(Hj.W)), Hj


@pytest.mark.parametrize("model,L,D", [("tfim", 8, 16), ("spin1", 6, 12)])
def test_one_dmrg2_sweep_matches_jax(model, L, D):
    """One sweep from the same state and environments, truncated to 6
    Schmidt values per bond: the energy to 1e-10, the Schmidt values at
    every bond to 1e-8, the discarded weight to 1e-10 and the overlap of
    the two results to 1 - 1e-10."""
    dt = np.float64
    Ht, Hj = _models(model, dt)
    d = Ht.physicaldim
    pj = jmps.FiniteMPS.random(jax.random.PRNGKey(7), L, d, D, dtype=dt)
    Wsj = jnp.real(jenv.stack_W(Hj, L)).astype(dt)
    w = Wsj.shape[1]
    GRsj = jenv.compute_right_envs(pj.ARs, Wsj, jenv.right_boundary(w, D, dt))
    sup = bond_support_vectors(L, d, D)
    scheme, inner_tol = tops.truncdim(6), 1e-8
    ALj, ARj, ACj, _, lamj, errj, _ = _jax_sweep2(
        pj.ALs, pj.ARs, pj.AC, Wsj, GRsj, jnp.asarray(inner_tol), 10, 4,
        _jscheme(scheme), sup=jnp.asarray(sup))

    pt = finite_mps_from_numpy(np.asarray(pj.ALs), np.asarray(pj.ARs),
                               np.asarray(pj.AC), 0, "cpu")
    Wst = stack_W(Ht, L, torch.float64, "cpu")
    GRst = compute_right_envs(pt.ARs, Wst,
                              right_boundary(w, D, torch.float64, "cpu"))
    with matmul_precision():
        ALt, ARt, ACt, _, lamt, errt, diag = _dmrg2_sweep_impl(
            pt.ALs, pt.ARs, pt.AC, Wst, GRst, inner_tol, 10, 4, scheme,
            sup=torch.from_numpy(sup))

    assert abs(lamt - float(lamj)) <= 1e-10
    assert errt > 1e-9 and abs(errt - float(errj)) <= 1e-10
    qt = FiniteMPS(ALt, ARt, ACt, 0)
    qj = jmps.FiniteMPS(ALj, ARj, ACj, 0)
    for bond in range(1, L):
        np.testing.assert_allclose(
            _np(entanglement_spectrum(qt, bond)),
            np.asarray(jtool.entanglement_spectrum(qj, bond)), rtol=0,
            atol=1e-8)
    qc = finite_mps_from_numpy(np.asarray(ALj), np.asarray(ARj),
                               np.asarray(ACj), 0, "cpu")
    assert abs(complex(qt.dot(qc))) >= 1 - 1e-10


def _ed(H, L):
    """Ground energy and vector of H on L sites."""
    w, v = np.linalg.eigh(H.to_matrix(L))
    return float(w[0]), v[:, 0]


def test_dmrg2_tfim_matches_ed():
    """The JAX package's `test_dmrg2_tfim_vs_ed` case, on the port; then the
    same through `find_groundstate(psi, H, trscheme=...)` (DMRG2 followed by
    one-site DMRG)."""
    L, D = 8, 16
    H = transverse_field_ising(g=1.1)
    e0, _ = _ed(H, L)
    psi0 = FiniteMPS.random(L, 2, D, torch.complex128, "cpu",
                            torch.Generator().manual_seed(0))
    psi, envs, eps = find_groundstate(
        psi0, H, DMRG2(tol=1e-11, maxiter=40, trscheme=tops.truncbelow(1e-9)))
    assert abs(float(expectation_value(psi, H, envs=envs)) - e0) <= 1e-8
    assert eps < 1e-11
    psi, envs, eps = find_groundstate(psi0, H,
                                      trscheme=tops.truncbelow(1e-9))
    assert abs(float(expectation_value(psi, H, envs=envs)) - e0) <= 1e-8
    assert eps < 1e-10


def test_dmrg2_heisenberg_matches_ed_and_its_entanglement():
    """The JAX package's spin-1/2 Heisenberg L=6 case: the energy to 1e-8
    of ED, and the Schmidt values and entropy of the middle bond to 1e-8 of
    those of the exact ground vector."""
    L, D = 6, 8
    H = heisenberg_XXX(spin=0.5)
    e0, v0 = _ed(H, L)
    psi = FiniteMPS.random(L, 2, D, torch.complex128, "cpu",
                           torch.Generator().manual_seed(1))
    psi, envs, _ = find_groundstate(psi, H, DMRG2(tol=1e-10, maxiter=40))
    assert abs(float(expectation_value(psi, H, envs=envs)) - e0) <= 1e-8
    S_ed = np.linalg.svd(v0.reshape(2 ** (L // 2), -1), compute_uv=False)
    S = _np(entanglement_spectrum(psi, L // 2))
    np.testing.assert_allclose(S[:S_ed.size], S_ed, rtol=0, atol=1e-8)
    p = S_ed ** 2
    assert abs(float(entropy(psi, L // 2))
               + np.sum(p[p > 0] * np.log(p[p > 0]))) <= 1e-8


@functools.cache
def _jax_state(L, d, D):
    return jimps.InfiniteMPS.random(jax.random.PRNGKey(20 + L), L, d, D)


_jax_envs = jax.jit(jinf.hamiltonian_environments)


def _carry(pj):
    return infinite_mps_from_numpy(np.asarray(pj.AL), np.asarray(pj.AR),
                                   np.asarray(pj.AC), np.asarray(pj.C), "cpu")


def _infinite_inputs(L, D):
    """TFIM with period L, a JAX state and its environments, and their
    carried copies."""
    Hj = jham.transverse_field_ising_lattice(g=G, period=L)
    Ht = mpo_from_numpy(np.asarray(Hj.W))
    pj = _jax_state(L, 2, D)
    ej = _jax_envs(pj, Hj)
    Wsj = jnp.stack([Hj.site(i) for i in range(L)]).astype(pj.dtype)
    Wst = stack_W(Ht, L, torch.complex128, "cpu")
    return pj, ej, Wsj, _carry(pj), Wst


@pytest.mark.parametrize("L", [1, 2, 3])
def test_one_idmrg1_iteration_matches_jax(L):
    """lam and err to 1e-10; the new GLs, GRs and Cs elementwise to 1e-9
    (a roll off by one would show at L = 2, 3)."""
    pj, ej, Wsj, pt, Wst = _infinite_inputs(L, 6)
    outj = jidmrg._idmrg1_iteration(pj.AL, pj.AR, pj.AC[0], pj.C, ej.GLs,
                                    ej.GRs, 10, 20, Ws=Wsj, inner_tol=1e-12)
    with matmul_precision():
        outt = _idmrg1_iteration(pt.AL, pt.AR, pt.AC[0], pt.C, _t(ej.GLs),
                                 _t(ej.GRs), 10, 20, Ws=Wst, inner_tol=1e-12)
    assert outt[8][0] == 0
    assert abs(outt[6] - float(outj[6])) <= 1e-10
    assert abs(float(outt[7]) - float(outj[7])) <= 1e-10
    for k in (3, 4, 5):  # Cs, GLs, GRs
        np.testing.assert_allclose(_np(outt[k]), np.asarray(outj[k]),
                                   rtol=0, atol=1e-9)


@pytest.mark.parametrize("L", [2, 3])
def test_one_idmrg2_iteration_matches_jax(L):
    """lam to 1e-10; the Schmidt values of every bond, dC and the
    discarded weight to 1e-9."""
    D = 6
    pj, ej, Wsj, pt, Wst = _infinite_inputs(L, D)
    Ss = np.stack([np.linalg.svd(np.asarray(pj.C[i]), compute_uv=False)
                   for i in range(L)])
    scheme = tops.truncbelow(1e-10)
    outj = jidmrg._idmrg2_iteration(pj.AL, pj.AR, pj.AC[0], jnp.asarray(Ss),
                                    ej.GLs, ej.GRs, 10, 20, _jscheme(scheme),
                                    Ws=Wsj, inner_tol=1e-12)
    with matmul_precision():
        outt = _idmrg2_iteration(pt.AL, pt.AR, pt.AC[0], _t(Ss), _t(ej.GLs),
                                 _t(ej.GRs), 10, 20, scheme, Ws=Wst,
                                 inner_tol=1e-12)
    assert outt[9][0] == 0
    assert abs(outt[6] - float(outj[6])) <= 1e-10
    np.testing.assert_allclose(_np(outt[3]), np.asarray(outj[3]), rtol=0,
                               atol=1e-9)
    for k in (7, 8):  # dC, err_trunc
        assert abs(float(outt[k]) - float(outj[k])) <= 1e-9
    assert float(outt[8]) > 1e-6  # theta of rank D d is cut to D
    for bond in range(L):  # the infinite entanglement spectrum
        np.testing.assert_allclose(
            _np(entanglement_spectrum(pt, bond)),
            np.asarray(jtool.entanglement_spectrum(pj, bond)), rtol=0,
            atol=1e-12)


def test_find_groundstate_idmrg_matches_the_integral():
    """IDMRG1 on a one-site cell and IDMRG2 on a two-site cell, TFIM
    g = 1.5 at D = 12, float64: the energy density within 1e-6 of the
    exact one (the JAX package's `test_idmrg.py` cases)."""
    gen = torch.Generator().manual_seed(3)
    H = transverse_field_ising_lattice(g=G)
    psi = InfiniteMPS.random(1, 2, 12, torch.float64, "cpu", gen)
    psi, envs, err = find_groundstate(psi, H, IDMRG1(tol=1e-10, maxiter=300))
    assert err < 1e-10
    assert abs(float(expectation_value(psi, H, envs=envs)[0]) - TFIM_E0) < 1e-6
    H2 = transverse_field_ising_lattice(g=G, period=2)
    psi = InfiniteMPS.random(2, 2, 12, torch.float64, "cpu", gen)
    psi, envs, err = find_groundstate(
        psi, H2, IDMRG2(tol=1e-10, maxiter=200,
                        trscheme=tops.truncbelow(1e-10)))
    assert psi.period == 2
    np.testing.assert_allclose(_np(expectation_value(psi, H2, envs=envs)),
                               TFIM_E0, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="at least 2"):
        find_groundstate(InfiniteMPS.random(1, 2, 4, torch.float64, "cpu",
                                            gen), H, IDMRG2(maxiter=1))


def test_environment_regularization_matches_jax():
    """_reg_left/_reg_right remove the identity component of the top
    (bottom) FSM level, as in JAX."""
    from mpskit_tpu_torch.algorithms import idmrg as tidmrg

    rng = np.random.default_rng(4)
    G_, C = rng.standard_normal((3, 5, 5)), rng.standard_normal((5, 5))
    for tf, jf in ((tidmrg._reg_left, jidmrg._reg_left),
                   (tidmrg._reg_right, jidmrg._reg_right)):
        np.testing.assert_allclose(_np(tf(_t(G_), _t(C))),
                                   np.asarray(jf(jnp.asarray(G_),
                                                 jnp.asarray(C))),
                                   rtol=0, atol=1e-14)
