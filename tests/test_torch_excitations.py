"""The excitations slice of the PyTorch port (quasiparticle states, their
environments and gauges, QuasiparticleAnsatz, FiniteExcited and the
smallest-real Arnoldi) against the JAX package and exact diagonalization.

Both packages get the same numbers: states are made by one package and
carried across, and the null-space bases (which a complete QR fixes only
up to a unitary) are carried from the JAX QP through `interop`. Tests that
let each package draw its own start vectors compare eigenvalues and other
invariants only. The JAX references of the infinite QP environments run
with jit disabled: one GMRES solve compiles for longer than it runs."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import dmrgexcitation as jdx
from mpskit_tpu.environments import qp as jqpe
from mpskit_tpu.linalg import arnoldi as jarn
from mpskit_tpu.models import hamiltonians as jham
from mpskit_tpu.states import finitemps as jmps
from mpskit_tpu.states import infinitemps as jimps
from mpskit_tpu.states import quasiparticle as jqp
from mpskit_tpu_torch import (
    DMRG, VUMPS, FiniteExcited, FiniteMPS, InfiniteMPS, QuasiparticleAnsatz,
    excitations, expectation_value, find_groundstate,
    finite_left_to_right_gauge, finite_right_to_left_gauge,
    left_to_right_gauge, qp_to_finitemps, right_to_left_gauge,
    transverse_field_ising, transverse_field_ising_lattice,
)
from mpskit_tpu_torch.algorithms import dmrgexcitation as tdx_t
from mpskit_tpu_torch.environments import infinite_ham as tinf
from mpskit_tpu_torch.environments import qp as tqpe
from mpskit_tpu_torch.interop import (
    finite_qp_from_numpy, left_gauged_qp_from_numpy, mpo_from_numpy,
)
from mpskit_tpu_torch.linalg import arnoldi as tarn
from mpskit_tpu_torch.operators.mpo import DenseMPO
from mpskit_tpu_torch.states.quasiparticle import (
    FiniteQP, LeftGaugedQP, full_gauges,
)
from mpskit_tpu_torch.states.qp_gauge import _bond_masks

# the package re-exports the `excitations` function under the module's
# name, so the modules are imported by path
jexc = importlib.import_module("mpskit_tpu.algorithms.excitations")
texc = importlib.import_module("mpskit_tpu_torch.algorithms.excitations")

torch.set_num_threads(1)


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(name):
    """(port H, JAX H) with the same FSM."""
    Hj = (jham.transverse_field_ising_lattice(g=1.5) if name == "tfim"
          else jham.heisenberg_XXX(spin=1))
    return mpo_from_numpy(np.asarray(Hj.W)), Hj


def _to_jax(pt):
    return jimps.InfiniteMPS(*(jnp.asarray(_np(x))
                               for x in (pt.AL, pt.AR, pt.AC, pt.C)))


def _ed_gaps(H, L, k):
    w = np.linalg.eigvalsh(H.to_matrix(L))
    return w[1:k + 1] - w[0]


def test_smallest_eigs_arnoldi_matches_jax_and_eig():
    """A gapped non-Hermitian matrix: the smallest-real-part eigenvalue of
    both packages and of numpy, and the eigenvector up to its phase."""
    rng = np.random.default_rng(0)
    n = 40
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = Q @ (np.diag(np.linspace(1.0, 5.0, n))
             + np.triu(0.3 * rng.standard_normal((n, n)), 1)) @ Q.T
    A[0, 0] -= 2.0       # a gap below the rest
    v0 = rng.standard_normal(n)
    w = np.linalg.eigvals(A)
    exact = w[np.argmin(w.real)]
    At, Aj = _t(A), jnp.asarray(A)
    res_t = tarn.smallest_eigs_arnoldi(lambda x: At @ x, _t(v0), 20, 60,
                                       1e-12)
    res_j = jarn.smallest_eigs_arnoldi(lambda x: Aj @ x, jnp.asarray(v0), 20,
                                       60, 1e-12)
    assert res_t.converged and isinstance(res_t.eigenvalue, float)
    assert abs(res_t.eigenvalue - exact.real) <= 1e-10
    assert abs(res_t.eigenvalue - float(res_j.eigenvalue)) <= 1e-10
    x_t, x_j = _np(res_t.eigenvector), np.asarray(res_j.eigenvector)
    np.testing.assert_allclose(abs(np.vdot(x_t, x_j)), 1.0, atol=1e-8)
    np.testing.assert_allclose(A @ x_t, exact.real * x_t, atol=1e-9)


@pytest.mark.parametrize("model,L,p,dtype", [
    ("tfim", 1, 0.0, torch.float64), ("spin1", 1, np.pi, torch.float64),
    ("tfim", 2, np.pi, torch.float64), ("tfim", 3, 0.7, torch.complex128)])
def test_qp_environments_and_matvec_match_jax(model, L, p, dtype,
                                              monkeypatch):
    """lBs, rBs and the QP matvec elementwise against JAX from one random
    state, one set of ground-state environments and the JAX QP's X and VL:
    the seats of the cyclic solves (lB_i left of site i, rB_i right of it)
    at cells of 1-3 sites, the real phase -1 at p = pi and the complex
    phase and its conjugate on the right at p = 0.7."""
    Ht, Hj = _models(model)
    d, D = Ht.physicaldim, 4
    pt = InfiniteMPS.random(L, d, D, dtype, "cpu",
                            torch.Generator().manual_seed(L))
    pj = _to_jax(pt)
    et = tinf.hamiltonian_environments(pt, Ht)
    qj = jqp.LeftGaugedQP.random(jax.random.PRNGKey(L), pj, momentum=p)
    qt = left_gauged_qp_from_numpy(np.asarray(qj.Xs), np.asarray(qj.VLs),
                                   pt, p)
    GLj, GRj = jnp.asarray(_np(et.GLs)), jnp.asarray(_np(et.GRs))
    with jax.disable_jit():
        lj = jqpe.qp_left_envs(qj, GLj, Hj)
        rj = jqpe.qp_right_envs(qj, GRj, Hj)
    lt = tqpe.qp_left_envs(qt, et.GLs, Ht)
    rt = tqpe.qp_right_envs(qt, et.GRs, Ht)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(_np(rt), np.asarray(rj), rtol=0, atol=1e-10)
    # the JAX matvec on the same B-environments
    monkeypatch.setattr(jexc, "qp_left_envs", lambda *a, **k: lj)
    monkeypatch.setattr(jexc, "qp_right_envs", lambda *a, **k: rj)
    Es = texc._renorm_energies_infinite(pt, Ht, et)
    yj = jexc._qp_matvec_infinite(qj.Xs, qj, Hj, GLj, GRj,
                                  jnp.asarray(_np(Es)), 1e-10)
    yt = texc._qp_matvec_infinite(qt.Xs, qt, Ht, et.GLs, et.GRs, Es, 1e-10)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), rtol=0, atol=1e-10)
    # a real dtype takes only p = 0 mod pi
    if not dtype.is_complex:
        with pytest.raises(AssertionError, match="complex dtype"):
            tqpe._phase(0.7, dtype)


@pytest.fixture(scope="module")
def tfim_finite_gs():
    """The JAX test's finite TFIM (g=3, L=8, D=16) ground state, made by
    the port's DMRG, with its JAX copy."""
    H = transverse_field_ising(g=3.0)
    psi = FiniteMPS.random(8, 2, 16, torch.float64, "cpu",
                           torch.Generator().manual_seed(0))
    psi, _, _ = find_groundstate(psi, H, DMRG(tol=1e-10, maxiter=50,
                                              verbosity=0))
    pj = jmps.FiniteMPS(*(jnp.asarray(_np(x))
                          for x in (psi.ALs, psi.ARs, psi.AC)), psi.center)
    return H, psi, pj


def _jax_finite_envs(Hj, qj, L, D):
    from mpskit_tpu.environments import finite as jenv

    Ws = jenv.stack_W(Hj, L).astype(jnp.float64)
    w = Ws.shape[1]
    GLs = jenv.compute_left_envs(qj.ALs, Ws,
                                 jenv.left_boundary(w, D, jnp.float64))
    GRs = jenv.compute_right_envs(qj.ARs, Ws,
                                  jenv.right_boundary(w, D, jnp.float64))
    return Ws, GLs, GRs, jnp.real(GLs[L][w - 1, 0, 0])


def test_finite_qp_matches_ed_and_jax(tfim_finite_gs):
    """The two lowest QP energies against ED (atol 1e-4, the JAX test's
    oracle) and against the JAX package's from the same ground state, null
    spaces and start vector (1e-7); the JAX matvec on the port's start
    elementwise."""
    H, psi, pj = tfim_finite_gs
    Hj = jham.transverse_field_ising(g=3.0)
    alg = QuasiparticleAnsatz(tol=1e-8)
    es_t, _ = excitations(H, alg, psi, num=2)
    np.testing.assert_allclose(np.sort(_np(es_t)), _ed_gaps(H, 8, 2),
                               rtol=0, atol=1e-4)
    # the port's start vector (its default generator, seeded 0) and
    # gauges, carried into the JAX package
    q0 = FiniteQP.random(psi, generator=torch.Generator().manual_seed(0))
    arrays = [_np(x) for x in (q0.Xs, q0.VLs, q0.ALs, q0.ARs, q0.mask)]
    qt = finite_qp_from_numpy(*arrays, device="cpu")
    qj = jqp.FiniteQP(*(jnp.asarray(a) for a in arrays))
    Ws, GLs, GRs, E0 = _jax_finite_envs(Hj, qj, 8, 16)
    Wt, GLt, GRt = (_t(x) for x in (Ws, GLs, GRs))
    yj = jexc._qp_matvec_finite(qj.Xs, qj, Ws, GLs, GRs, E0)
    yt = texc._qp_matvec_finite(qt.Xs, qt, Wt, GLt, GRt, float(E0))
    np.testing.assert_allclose(_np(yt), np.asarray(yj), rtol=0, atol=1e-10)
    shift = 100.0 * max(1.0, abs(float(E0)))
    es_j, xs = [], []
    mv_j = jax.jit(lambda X: jexc._qp_matvec_finite(X, qj, Ws, GLs, GRs, E0))
    for _ in range(2):
        found = tuple(xs)

        def mv(X, _found=found):
            y = mv_j(X)
            for xf in _found:
                y = y + shift * jnp.vdot(xf, X) * xf
            return y

        res = jexc._qp_eigsolve(mv, qj.Xs, alg)
        es_j.append(float(res.eigenvalue))
        xs.append(res.eigenvector)
    np.testing.assert_allclose(_np(es_t), es_j, rtol=0, atol=1e-7)


def test_finite_qp_gauge_round_trip_and_embedding(tfim_finite_gs):
    """left -> right -> left gives B back to 1e-10 and the right gauge
    condition holds on the supported bond blocks; the left gauge fixed by
    construction; the embedded FiniteMPS of both gauges is one state, and
    its energy above the ground state is the QP eigenvalue."""
    H, psi, _ = tfim_finite_gs
    es, qps = texc.excitations_finite(H, QuasiparticleAnsatz(tol=1e-10), psi)
    qp = qps[0]
    qpr = finite_left_to_right_gauge(qp)
    bm = _bond_masks(8, 2, 16, torch.float64, "cpu")
    res = torch.einsum("nlpr,nmpr->nlm", qpr.bs(), qp.ARs.conj())
    assert float((res * bm[:8]).abs().max()) < 1e-10
    back = finite_right_to_left_gauge(qpr)
    assert float((back.bs() - qp.bs()).abs().max()) < 1e-10
    ml, mr = qp_to_finitemps(qp), qp_to_finitemps(qpr)
    ov = abs(complex(ml.dot(mr))) / abs(complex(ml.dot(ml)))
    assert abs(1 - ov) < 1e-10
    e0 = float(expectation_value(psi, H))
    e_qp = float(expectation_value(ml, H)) - e0
    assert abs(e_qp - float(es[0])) < 1e-8
    # the ground state is orthogonal to the excitation
    assert abs(complex(psi.dot(ml))) < 1e-10


@pytest.mark.parametrize("p", [0.0, 0.7])
def test_infinite_qp_gauge_round_trip(p):
    """left -> right -> left on a random complex128 QP: the right gauge
    condition to 1e-9 and the B tensors back to 1e-8, as the JAX test
    checks, and the right gauge against JAX from the carried QP."""
    H = transverse_field_ising(g=1.5)
    psi = InfiniteMPS.random(1, 2, 6, torch.complex128, "cpu",
                             torch.Generator().manual_seed(0))
    psi, _, _ = find_groundstate(psi, H, VUMPS(tol=1e-10, maxiter=60,
                                               verbosity=0))
    qp = LeftGaugedQP.random(psi, momentum=p,
                             generator=torch.Generator().manual_seed(1))
    qpr = left_to_right_gauge(qp)
    res = torch.einsum("nlpr,nmpr->nlm", qpr.bs(), psi.AR.conj())
    assert float(res.abs().max()) < 1e-9
    back = right_to_left_gauge(qpr)
    assert float((back.bs() - qp.bs()).abs().max()) < 1e-8
    res2 = torch.einsum("nlpm,nlpr->nmr", psi.AL.conj(), back.bs())
    assert float(res2.abs().max()) < 1e-9
    from mpskit_tpu.states import qp_gauge as jgauge

    qj = jqp.LeftGaugedQP(jnp.asarray(_np(qp.Xs)), jnp.asarray(_np(qp.VLs)),
                          _to_jax(psi), _to_jax(psi), p, True)
    with jax.disable_jit():
        Bj = jgauge.left_to_right_gauge(qj).bs()
    np.testing.assert_allclose(_np(qpr.bs()), np.asarray(Bj), rtol=0,
                               atol=1e-10)


@pytest.fixture(scope="module")
def tfim_infinite_gs():
    H = transverse_field_ising_lattice(g=1.5)
    psi = InfiniteMPS.random(1, 2, 6, torch.complex128, "cpu",
                             torch.Generator().manual_seed(2))
    psi, envs, _ = find_groundstate(psi, H, VUMPS(tol=1e-10, maxiter=100,
                                                  verbosity=0))
    return H, psi, envs


def test_batched_dispersion_matches_per_momentum_solve(tfim_infinite_gs):
    """The dispersion over three momenta against one solve per momentum
    from another start vector (1e-8), and near the exact TFIM dispersion
    2 sqrt(1 + g^2 - 2 g cos p) at D=6."""
    H, psi, envs = tfim_infinite_gs
    momenta = [0.0, 0.7, np.pi]
    alg = QuasiparticleAnsatz(tol=1e-10)
    batched = texc.excitations_infinite_batched(H, alg, momenta, psi,
                                                envs=envs)
    assert batched.shape == (3,)
    single = []
    for p in momenta:
        es, qps = excitations(H, alg, p, psi, envs=envs,
                              generator=torch.Generator().manual_seed(1))
        assert es.shape == (1, 1) and qps[0][0].momentum == p
        single.append(float(es[0, 0]))
    np.testing.assert_allclose(_np(batched), single, rtol=0, atol=1e-8)
    exact = 2 * np.sqrt(1 + 1.5 ** 2 - 2 * 1.5 * np.cos(momenta))
    np.testing.assert_allclose(_np(batched), exact, rtol=0, atol=5e-3)


def test_infinite_qp_arnoldi_matches_lanczos(tfim_infinite_gs):
    """solver="arnoldi" finds the Lanczos eigenvalue at p = 0.7."""
    H, psi, envs = tfim_infinite_gs
    es = [float(excitations(H, QuasiparticleAnsatz(tol=1e-9, solver=s), 0.7,
                            psi, envs=envs)[0][0, 0].real)
          for s in ("lanczos", "arnoldi")]
    assert abs(es[0] - es[1]) <= 1e-7


def test_finite_excited_matches_ed_and_jax():
    """FiniteExcited above one ground state: the first excited energy
    against ED, orthogonal to the ground state, and against the JAX
    package's penalized sweeps from the port's random start."""
    from mpskit_tpu.environments import finite as jenv
    from mpskit_tpu.utils.dynamictols import updatetol

    L, D = 6, 8
    Hj = jham.transverse_field_ising(g=1.5)
    H = mpo_from_numpy(np.asarray(Hj.W))
    psi = FiniteMPS.random(L, 2, D, torch.float64, "cpu",
                           torch.Generator().manual_seed(3))
    psi, _, _ = find_groundstate(psi, H, DMRG(tol=1e-12, maxiter=50,
                                              verbosity=0))
    alg = FiniteExcited(tol=1e-10, maxiter=40)
    es, states = excitations(H, alg, psi, num=1,
                             generator=torch.Generator().manual_seed(4))
    assert abs(float(es[0]) - np.linalg.eigvalsh(H.to_matrix(L))[1]) <= 1e-8
    assert abs(complex(psi.dot(states[0]))) <= 1e-5
    # the JAX sweeps, from the random state the port drew first
    start = FiniteMPS.random(L, 2, D, torch.float64, "cpu",
                             torch.Generator().manual_seed(4))
    pj = jmps.FiniteMPS(*(jnp.asarray(_np(x))
                          for x in (psi.ALs, psi.ARs, psi.AC)), psi.center)
    ALs_pen, ARs_pen = (x[None] for x in jqp.full_gauges(pj))
    ACs_pen = jnp.stack([pj.move_center(i).AC for i in range(L)])[None]
    Ws = jenv.stack_W(Hj, L).astype(jnp.float64)
    ALs, ARs, AC = (jnp.asarray(_np(x))
                    for x in (start.ALs, start.ARs, start.AC))
    GRs = jenv.compute_right_envs(
        ARs, Ws, jenv.right_boundary(Ws.shape[1], D, jnp.float64))
    lam_prev, eps = None, 1.0
    for it in range(1, alg.maxiter + 1):
        ALs, ARs, AC, GRs, lam = jdx._penalized_sweep(
            ALs, ARs, AC, Ws, GRs, ALs_pen, ARs_pen, ACs_pen,
            updatetol(eps, it), alg.krylovdim, alg.eig_maxrestarts,
            weight=alg.weight)
        lam = float(lam)
        eps = abs(lam - lam_prev) if lam_prev is not None else 1.0
        lam_prev = lam
        if eps < alg.tol:
            break
    assert abs(lam - float(es[0])) <= 1e-8
    # the overlap environments of the penalty against the excited state,
    # left and right, elementwise against JAX; both ends hold the overlap
    x = states[0]
    xg, pg = full_gauges(x), full_gauges(psi)
    vL = tdx_t._overlap_left_envs(pg[0][None], xg[0])
    vR = tdx_t._overlap_right_envs(pg[1][None], xg[1])
    xj = [jnp.asarray(_np(a)) for a in xg]
    np.testing.assert_allclose(
        _np(vL), np.asarray(jdx._overlap_left_envs(ALs_pen, xj[0])),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        _np(vR), np.asarray(jdx._overlap_right_envs(ARs_pen, xj[1])),
        rtol=0, atol=1e-12)
    ov = complex(x.dot(psi))
    assert abs(complex(vL[0, L, 0, 0]) - ov) <= 1e-10
    assert abs(complex(vR[0, 0, 0, 0]) - ov) <= 1e-10


def test_unported_branches_raise():
    """The reduced-MPO branch raises naming item 11. The charge sectors and
    symmetric states (item 11's abelian part) are ported: sector= on a
    plain state raises TypeError as in the JAX package, and stand-ins that
    only carry the symmetric names are no states."""
    H = transverse_field_ising(g=1.5)
    psi = InfiniteMPS.random(1, 2, 4, torch.float64, "cpu",
                             torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="SymmetricInfiniteMPS"):
        excitations(H, QuasiparticleAnsatz(), 0.0, psi, sector=1)
    fpsi = FiniteMPS.random(4, 2, 4, torch.float64, "cpu",
                            torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="SymmetricFiniteMPS"):
        excitations(H, QuasiparticleAnsatz(), fpsi, sector=1)
    for name in ("SymmetricFiniteMPS", "SymmetricInfiniteMPS"):
        sym = type(name, (), {})()
        with pytest.raises(TypeError):
            excitations(H, QuasiparticleAnsatz(), sym)
        with pytest.raises(TypeError):
            excitations(H, QuasiparticleAnsatz(), 0.0, sym)
    reduced = type("ReducedMPO", (), {})()
    with pytest.raises(NotImplementedError, match="item 11"):
        excitations(reduced, QuasiparticleAnsatz(), 0.0, psi)
    # a transfer MPO goes to the boundary excitations, which take
    # QuasiparticleAnsatz only
    O = DenseMPO.from_array(np.ones((1, 1, 2, 2)))
    with pytest.raises(TypeError, match="transfer MPO"):
        excitations(O, FiniteExcited(), 0.0, psi)
    with pytest.raises(TypeError):
        excitations(H, DMRG(), fpsi)
