"""Time evolution in the PyTorch port against the JAX package and against
exact exponentials: the Krylov exponentials, one finite TDVP step, one
TDVP2 step, one infinite TDVP step at unit cells 1 and 2, the exactness of
both finite integrators at full bond dimension, and the error paths.

Inputs are made with numpy from a seed, or by the JAX package and carried
across with `interop`, and fed to both packages in complex128. QR with a
positive diagonal is unique, so the one-site step is compared elementwise;
the SVD of TDVP2 and the uniform gauge fix leave phases free, so those are
compared through energies, Schmidt values and overlaps."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import expval as jexp
from mpskit_tpu.algorithms import tdvp as jtdvp
from mpskit_tpu.environments import finite as jenv
from mpskit_tpu.linalg import expm as jexpm
from mpskit_tpu.models import hamiltonians as jham
from mpskit_tpu.states import finitemps as jmps
from mpskit_tpu.states import infinitemps as jimps
from mpskit_tpu_torch import (
    DMRG, TDVP, TDVP2, FiniteMPS, InfiniteMPS, entanglement_spectrum,
    expectation_value, find_groundstate, heisenberg_XXX, timestep,
    transverse_field_ising,
)
from mpskit_tpu_torch.algorithms.tdvp import _timestep_finite, \
    _timestep_infinite
from mpskit_tpu_torch.environments.finite import (
    compute_right_envs, right_boundary, stack_W,
)
from mpskit_tpu_torch.interop import (
    finite_mps_from_numpy, infinite_mps_from_numpy, mpo_from_numpy,
)
from mpskit_tpu_torch.linalg import expm as texpm

torch.set_num_threads(1)

C128 = torch.complex128


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _carry(pj):
    return finite_mps_from_numpy(np.asarray(pj.ALs), np.asarray(pj.ARs),
                                 np.asarray(pj.AC), pj.center, "cpu")


def _carry_inf(pj):
    return infinite_mps_from_numpy(np.asarray(pj.AL), np.asarray(pj.AR),
                                   np.asarray(pj.AC), np.asarray(pj.C), "cpu")


def _vector(psi: FiniteMPS) -> np.ndarray:
    """The d^L state vector of a finite MPS (padded bond index 0 at both
    ends)."""
    p = psi.move_center(0)
    v = _np(p.AC)[:1]
    for i in range(1, psi.length):
        v = np.einsum("...m,mpr->...pr", v, _np(p.ARs[i]))
    return v[..., :1].reshape(-1)


def _exact_evolution(H, L, v0, t):
    """exp(-i H t) v0 from the eigendecomposition of the dense H."""
    E, V = np.linalg.eigh(H.to_matrix(L))
    return V @ (np.exp(-1j * E * t) * (V.conj().T @ v0))


# ---------------------------------------------------------------------------
# the Krylov exponentials
# ---------------------------------------------------------------------------

def _operator(n, hermitian, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    if hermitian:
        A = (A + A.conj().T) / 2
    return A / np.sqrt(n), v


@pytest.mark.parametrize("n,m", [(40, 10), (64, 20)])
@pytest.mark.parametrize("tau", [-0.7j, 0.3, 1 - 0.5j])
def test_expm_multiply_matches_jax(n, m, tau):
    """Hermitian A: exp(tau A) v and Saad's estimate against JAX to 1e-12
    (the estimate relative), and the value against the dense exponential
    within the estimate."""
    A, v = _operator(n, True, n + m)
    At, Aj = _t(A), jnp.asarray(A)
    yt, et = texpm.expm_multiply_err(lambda x: At @ x, _t(v), tau, m)
    yj, ej = jexpm.expm_multiply_err(lambda x: Aj @ x, jnp.asarray(v), tau, m)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), rtol=0, atol=1e-12)
    assert abs(et - float(ej)) <= 1e-12 * max(float(ej), 1e-3)
    np.testing.assert_allclose(
        _np(texpm.expm_multiply(lambda x: At @ x, _t(v), tau, m)), _np(yt),
        rtol=0, atol=0)
    E, V = np.linalg.eigh(A)
    exact = V @ (np.exp(tau * E) * (V.conj().T @ v))
    assert np.linalg.norm(_np(yt) - exact) <= 10 * et * np.linalg.norm(v) \
        + 1e-12


@pytest.mark.parametrize("n,m", [(40, 10), (64, 20)])
def test_expm_multiply_arnoldi_matches_jax(n, m):
    """General A: exp(tau A) v against JAX to 1e-12 at a real and a
    complex tau."""
    A, v = _operator(n, False, 3 * n + m)
    At, Aj = _t(A), jnp.asarray(A)
    for tau in (0.4, -0.25j):
        yt = texpm.expm_multiply_arnoldi(lambda x: At @ x, _t(v), tau, m)
        yj = jexpm.expm_multiply_arnoldi(lambda x: Aj @ x, jnp.asarray(v),
                                         tau, m)
        np.testing.assert_allclose(_np(yt), np.asarray(yj), rtol=0,
                                   atol=1e-12)


def test_expm_multiply_promotes_a_real_vector():
    """A real operator and vector with an imaginary tau give a complex
    result (as in JAX), and a real tau keeps the real dtype; both against
    the dense exponential to 1e-12."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((30, 30))
    A = (A + A.T) / 10
    v = rng.standard_normal(30)
    At = _t(A)
    E, V = np.linalg.eigh(A)
    for tau, dtype in ((-0.5j, C128), (0.5, torch.float64)):
        y = texpm.expm_multiply(lambda x: At @ x, _t(v), tau, 30)
        assert y.dtype == dtype
        exact = V @ (np.exp(tau * E) * (V.T @ v))
        np.testing.assert_allclose(_np(y), exact, rtol=0, atol=1e-12)


def test_pade_expm_matches_eigendecomposition():
    """The host Pade expm against exp of a diagonalizable matrix (norms
    that take 0 and several squarings)."""
    rng = np.random.default_rng(6)
    for scale in (0.1, 3.0, 40.0):
        X = rng.standard_normal((12, 12)) + 1j * rng.standard_normal((12, 12))
        A = scale * X / np.linalg.norm(X, 2)
        w, P = np.linalg.eig(A)
        ref = P @ np.diag(np.exp(w)) @ np.linalg.inv(P)
        np.testing.assert_allclose(texpm._pade_expm(A), ref, rtol=0,
                                   atol=1e-11 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# finite TDVP
# ---------------------------------------------------------------------------

_jax_step = jax.jit(jtdvp._timestep_finite, static_argnums=(5,))


def test_one_finite_step_matches_jax():
    """TFIM g=0.5, L=6, D=8, complex128, Krylov m=5 (so the estimate is
    well above rounding): the new ALs, ARs, AC and right environments
    elementwise to 1e-12 (QR with a positive diagonal is unique), the
    energy to 1e-10, the centre Schmidt values to 1e-9, the overlap to
    1 - 1e-10 and the Krylov estimate to 1e-8 relative; the inputs are
    not written."""
    L, D, m, dt = 6, 8, 5, 0.05
    Hj = jham.transverse_field_ising_lattice(g=0.5)
    Ht = mpo_from_numpy(np.asarray(Hj.W))
    pj = jmps.FiniteMPS.random(jax.random.PRNGKey(0), L, 2, D,
                               dtype=jnp.complex128)
    mask = jmps.support_mask(L, 2, D)
    mkj = jnp.asarray(mask).astype(jnp.complex128)
    Wsj = jenv.stack_W(Hj, L).astype(jnp.complex128)
    A0, R0, C0 = pj.ALs * mkj, pj.ARs * mkj, pj.AC * mkj[0]
    GRsj = jenv.compute_right_envs(
        R0, Wsj, jenv.right_boundary(Wsj.shape[1], D, jnp.complex128))
    outj = _jax_step(A0, R0, C0, Wsj, GRsj, m, 0.05, masks=jnp.asarray(mask))

    ins = [_t(a) for a in (A0, R0, C0)]
    Wst = stack_W(Ht, L, C128, "cpu")
    GRst = compute_right_envs(ins[1], Wst, right_boundary(3, D, C128, "cpu"))
    copies = [x.clone() for x in ins + [GRst]]
    outt = _timestep_finite(*ins, Wst, GRst, m, dt=dt,
                            masks=torch.from_numpy(mask))
    for a, b in zip(ins + [GRst], copies):
        assert torch.equal(a, b)
    for k in range(4):
        np.testing.assert_allclose(_np(outt[k]), np.asarray(outj[k]),
                                   rtol=0, atol=1e-12)
    assert outt[4] > 1e-9
    assert abs(outt[4] - float(outj[4])) <= 1e-8 * float(outj[4])

    qt = FiniteMPS(*outt[:3], 0)
    qj = jmps.FiniteMPS(*outj[:3], 0)
    assert abs(float(expectation_value(qt, Ht))
               - float(jexp.expectation_value(qj, Hj))) <= 1e-10
    qc = _carry(qj)
    np.testing.assert_allclose(
        _np(entanglement_spectrum(qt, L // 2)),
        _np(entanglement_spectrum(qc, L // 2)), rtol=0, atol=1e-9)
    assert abs(complex(qt.dot(qc))) >= 1 - 1e-10


def test_timestep_entry_matches_jax_and_leaves_psi_alone():
    """`timestep` itself (support masks, environments, three steps) against
    JAX's: the energy to 1e-10 and the overlap to 1 - 1e-10; the caller's
    state is unchanged."""
    L, D = 6, 8
    Hj = jham.transverse_field_ising_lattice(g=0.5)
    Ht = mpo_from_numpy(np.asarray(Hj.W))
    pj = jmps.FiniteMPS.random(jax.random.PRNGKey(1), L, 2, D,
                               dtype=jnp.complex128).move_center(3)
    pt = _carry(pj)
    before = [x.clone() for x in (pt.ALs, pt.ARs, pt.AC)]
    qj, qt = pj, pt
    for _ in range(3):
        qj, _ = jtdvp.timestep(qj, Hj, 0.0, 0.05, jtdvp.TDVP())
        qt, envs = timestep(qt, Ht, 0.0, 0.05, TDVP())
    assert envs is None and qt.center == 0
    for a, b in zip((pt.ALs, pt.ARs, pt.AC), before):
        assert torch.equal(a, b)
    assert abs(float(expectation_value(qt, Ht))
               - float(jexp.expectation_value(qj, Hj))) <= 1e-10
    assert abs(complex(qt.dot(_carry(qj)))) >= 1 - 1e-10
    assert abs(float(qt.norm()) - 1.0) <= 1e-12


def test_one_tdvp2_step_matches_jax():
    """Spin-1/2 Heisenberg, L=6, D=12 (the JAX package's TDVP2 case): the
    energy to 1e-10 and the Schmidt values of every bond to 1e-9, with and
    without a truncation, against JAX."""
    from mpskit_tpu.tensors import ops as jops
    from mpskit_tpu_torch import truncdim

    L, D = 6, 12
    Hj = jham.heisenberg_XXX(spin=0.5)
    Ht = mpo_from_numpy(np.asarray(Hj.W))
    pj = jmps.FiniteMPS.random(jax.random.PRNGKey(3), L, 2, D,
                               dtype=jnp.complex128)
    pt = _carry(pj)
    for jalg, talg in ((jtdvp.TDVP2(), TDVP2()),
                       (jtdvp.TDVP2(trscheme=jops.truncdim(5)),
                        TDVP2(trscheme=truncdim(5)))):
        qj, _ = jtdvp.timestep(pj, Hj, 0.0, 0.05, jalg)
        qt, _ = timestep(pt, Ht, 0.0, 0.05, talg)
        assert abs(float(expectation_value(qt, Ht))
                   - float(jexp.expectation_value(qj, Hj))) <= 1e-10
        qc = _carry(qj)
        for bond in range(1, L):
            np.testing.assert_allclose(
                _np(entanglement_spectrum(qt, bond)),
                _np(entanglement_spectrum(qc, bond)), rtol=0, atol=1e-9)


@pytest.mark.parametrize("alg", ["TDVP", "TDVP2"])
def test_finite_integrators_are_exact_at_full_bond_dimension(alg):
    """TFIM g=0.5, L=8, D=16 = 2^(L/2), three steps of dt=0.05 from a
    seeded random state: 1 - |<exp(-i H t) psi0 | psi(t)>| <= 1e-10, while
    the state itself moved."""
    L, D = 8, 16
    H = transverse_field_ising(g=0.5)
    psi = FiniteMPS.random(L, 2, D, C128, "cpu",
                           torch.Generator().manual_seed(4))
    v0 = _vector(psi)
    a = TDVP() if alg == "TDVP" else TDVP2()
    for _ in range(3):
        psi, _ = timestep(psi, H, 0.0, 0.05, a)
    exact = _exact_evolution(H, L, v0, 0.15)
    v = _vector(psi)
    assert 1 - abs(np.vdot(exact, v)) <= 1e-10
    assert 1 - abs(np.vdot(v0, v)) > 1e-3


def test_groundstate_picks_up_only_a_phase():
    """The JAX package's case (TFIM g=1.3, L=6, D=16): after a step from
    the DMRG ground state the energy is the same to 1e-8 and the overlap
    with the ground state is 1 to 1e-8."""
    L, D = 6, 16
    H = transverse_field_ising(g=1.3)
    psi = FiniteMPS.random(L, 2, D, C128, "cpu",
                           torch.Generator().manual_seed(1))
    psi, envs, _ = find_groundstate(psi, H, DMRG(tol=1e-10, maxiter=40,
                                                 verbosity=0))
    E0 = float(expectation_value(psi, H, envs=envs))
    psi_t, _ = timestep(psi, H, 0.0, 0.05, TDVP())
    assert abs(float(expectation_value(psi_t, H)) - E0) <= 1e-8
    assert abs(abs(complex(psi.dot(psi_t))) - 1.0) <= 1e-8


# ---------------------------------------------------------------------------
# infinite TDVP
# ---------------------------------------------------------------------------

@functools.cache
def _jax_infinite_state(L, d, D):
    return jimps.InfiniteMPS.random(jax.random.PRNGKey(30 + L), L, d, D)


_jax_inf_step = jax.jit(jtdvp._timestep_infinite, static_argnums=(3, 4, 5))


@pytest.mark.parametrize("model,L,D", [("tfim", 1, 8), ("tfim", 2, 8),
                                       ("spin1", 1, 10), ("spin1", 2, 8)])
def test_one_infinite_step_matches_jax(model, L, D):
    """One step from the same state (dt=0.05, Krylov m=20): the energy
    density of the result to 1e-9 (both through the port's expectation
    value), the Schmidt values of every C to 1e-8, the Krylov estimate to
    1e-8 absolute; the caller's state is unchanged."""
    if model == "tfim":
        Hj = jham.transverse_field_ising_lattice(g=0.5, period=L)
    else:
        Hj = jham.heisenberg_XXX(spin=1, period=L)
    Ht = mpo_from_numpy(np.asarray(Hj.W))
    pj = _jax_infinite_state(L, Ht.physicaldim, D)
    qj, _, errj = _jax_inf_step(pj, Hj, 0.05, 20, 1e-13, 1e-12)
    pt = _carry_inf(pj)
    before = [x.clone() for x in (pt.AL, pt.AR, pt.AC, pt.C)]
    qt, envs, errt = _timestep_infinite(pt, Ht, 0.05, 20, 1e-13, 1e-12)
    for a, b in zip((pt.AL, pt.AR, pt.AC, pt.C), before):
        assert torch.equal(a, b)
    qc = _carry_inf(qj)
    np.testing.assert_allclose(_np(expectation_value(qt, Ht)),
                               _np(expectation_value(qc, Ht)), rtol=0,
                               atol=1e-9)
    for i in range(L):
        np.testing.assert_allclose(_np(torch.linalg.svdvals(qt.C[i])),
                                   _np(torch.linalg.svdvals(qc.C[i])),
                                   rtol=0, atol=1e-8)
    assert abs(errt - float(errj)) <= 1e-8
    assert qt.AL.shape == (L, D, Ht.physicaldim, D)


def test_masked_infinite_step_matches_jax():
    """The A_mask/C_mask branch (local regauge, no uniform gauge fix) on a
    two-site TFIM cell at D=8, with a mask that cuts a block from every
    bond: AL, AR, AC and C elementwise against JAX to 1e-10, and the
    masked entries exactly 0."""
    L, D = 2, 8
    Hj = jham.transverse_field_ising_lattice(g=0.5, period=L)
    Ht = mpo_from_numpy(np.asarray(Hj.W))
    keep = np.arange(D) < D - 2
    C_mask = np.broadcast_to(keep[:, None] & keep[None, :], (L, D, D))
    A_mask = np.broadcast_to(keep[:, None, None] & keep[None, None, :],
                             (L, D, 2, D))
    pj = _jax_infinite_state(L, 2, D)
    qj, _, _ = _jax_inf_step(pj, Hj, 0.05, 20, 1e-13, 1e-12,
                             A_mask=jnp.asarray(A_mask),
                             C_mask=jnp.asarray(C_mask))
    qt, _, _ = _timestep_infinite(_carry_inf(pj), Ht, 0.05, 20, 1e-13, 1e-12,
                                  A_mask=torch.from_numpy(A_mask.copy()),
                                  C_mask=torch.from_numpy(C_mask.copy()))
    for name in ("AL", "AR", "AC", "C"):
        np.testing.assert_allclose(_np(getattr(qt, name)),
                                   np.asarray(getattr(qj, name)), rtol=0,
                                   atol=1e-10)
    assert not _np(qt.AL)[~A_mask].any() and not _np(qt.C)[~C_mask].any()


def test_infinite_timestep_threads_its_environments():
    """`timestep` on an InfiniteMPS returns the step's environments; fed
    back, they warm-start the next step, which agrees with a cold one
    to 1e-9 in the energy density. The TFIM ground state (g=1.2 -> 1.5,
    D=8) keeps its norm and gauge."""
    from mpskit_tpu_torch import VUMPS, transverse_field_ising_lattice

    H0 = transverse_field_ising_lattice(g=1.2)
    H1 = transverse_field_ising_lattice(g=1.5)
    psi = InfiniteMPS.random(1, 2, 8, torch.float64, "cpu",
                             torch.Generator().manual_seed(2))
    psi, _, _ = find_groundstate(psi, H0, VUMPS(tol=1e-10, maxiter=100,
                                                verbosity=0))
    psi = InfiniteMPS(*(x.to(C128) for x in (psi.AL, psi.AR, psi.AC, psi.C)))
    p1, envs = timestep(psi, H1, 0.0, 0.05, TDVP())
    warm, _ = timestep(p1, H1, 0.05, 0.05, TDVP(), envs=envs)
    cold, _ = timestep(p1, H1, 0.05, 0.05, TDVP())
    np.testing.assert_allclose(_np(expectation_value(warm, H1)),
                               _np(expectation_value(cold, H1)), rtol=0,
                               atol=1e-9)
    assert abs(float(torch.linalg.vector_norm(warm.C[0])) - 1) <= 1e-12
    AL = warm.AL[0]
    np.testing.assert_allclose(
        _np(torch.einsum("lpm,lpn->mn", AL.conj(), AL)), np.eye(8), rtol=0,
        atol=1e-10)


# ---------------------------------------------------------------------------
# error paths
# ---------------------------------------------------------------------------

def test_a_real_state_or_a_wrong_argument_raises_type_error():
    H = transverse_field_ising(g=0.5)
    gen = torch.Generator().manual_seed(0)
    psi = FiniteMPS.random(4, 2, 4, torch.float64, "cpu", gen)
    for alg in (TDVP(), TDVP2()):
        with pytest.raises(TypeError, match="complex"):
            timestep(psi, H, 0.0, 0.05, alg)
    ipsi = InfiniteMPS.random(1, 2, 4, torch.float64, "cpu", gen)
    with pytest.raises(TypeError, match="complex"):
        timestep(ipsi, H, 0.0, 0.05)
    cpsi = InfiniteMPS(*(x.to(C128) for x in (ipsi.AL, ipsi.AR, ipsi.AC,
                                              ipsi.C)))
    with pytest.raises(TypeError, match="TDVP2 evolves a FiniteMPS"):
        timestep(cpsi, H, 0.0, 0.05, TDVP2())
    with pytest.raises(TypeError, match="MPOHamiltonian"):
        timestep(cpsi, H.W, 0.0, 0.05)


@pytest.mark.parametrize("name,item,where", [
    ("WindowMPS", 10, "psi"), ("Window", 10, "H"), ("LazySum", 10, "H"),
    ("MultipliedOperator", 10, "H"), ("SU2FiniteMPS", 11, "psi"),
    ("SymmetricFiniteMPS", 11, "psi"), ("SymmetricInfiniteMPS", 11, "psi")])
def test_unported_branches_name_their_queue_item(name, item, where):
    """SU2FiniteMPS raises NotImplementedError naming item 11. The abelian
    symmetric states of item 11 and the item-10 types are ported: the real
    WindowMPS, Window, LazySum and MultipliedOperator take a step (a Window
    or a lazy sum at the midpoint equal to the plain operator there; the
    symmetric states in tests/test_torch_symmetric_tdvp.py), and stand-ins
    that only carry those names raise TypeError."""
    stand_in = type(name, (), {})()
    H = heisenberg_XXX(spin=0.5)
    psi = FiniteMPS.random(4, 2, 4, C128, "cpu",
                           torch.Generator().manual_seed(0))
    args = (stand_in, H) if where == "psi" else (psi, stand_in)
    if name.startswith("Symmetric"):
        with pytest.raises(TypeError):
            timestep(*args, 0.0, 0.05)
        return
    if item == 11:
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            timestep(*args, 0.0, 0.05)
        return
    with pytest.raises(TypeError):
        timestep(*args, 0.0, 0.05)
    from mpskit_tpu_torch import (
        LazySum, TimedOperator, UntimedOperator, Window, WindowMPS,
    )

    ref, _ = timestep(psi, H * 0.75, 0.0, 0.05)
    if name == "WindowMPS":
        ipsi = InfiniteMPS.random(1, 2, 4, C128, "cpu",
                                  torch.Generator().manual_seed(1))
        win = WindowMPS.from_infinite(ipsi, 4, device="cpu")
        out, envs = timestep(win, H, 0.0, 0.05)
        assert envs is None and out.window.AC.shape == win.window.AC.shape
        return
    op = {"Window": Window(UntimedOperator(H, 0.75)),
          "LazySum": LazySum([UntimedOperator(H, 0.5),
                              TimedOperator(H, lambda t: 10 * t)]),
          "MultipliedOperator": TimedOperator(H, lambda t: 30 * t)}[name]
    if name == "Window":
        with pytest.raises(TypeError, match="WindowMPS"):
            timestep(psi, op, 0.0, 0.05)
        return
    out, _ = timestep(psi, op, 0.0, 0.05)   # both at t + dt/2 = 0.025
    np.testing.assert_allclose(out.AC.numpy(), ref.AC.numpy(), rtol=0,
                               atol=1e-14)
