"""The infinite slice of the PyTorch port (VUMPS and what it runs on)
against the JAX package and against the exact TFIM energy density.

Inputs are made with numpy from a seed, or by the JAX package and carried
across with `interop`, and fed to both packages in float64 / complex128.
Where eigenvector phases leave more than one right answer the tests
compare gauge-invariant quantities: energies, Schmidt values, the VUMPS
convergence measure eps."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import expval_infinite as jexp
from mpskit_tpu.algorithms import vumps as jvumps
from mpskit_tpu.environments import infinite_ham as jinf
from mpskit_tpu.linalg import arnoldi as jarn
from mpskit_tpu.linalg import gmres as jgm
from mpskit_tpu.models import hamiltonians as jham
from mpskit_tpu.states import gauging as jgau
from mpskit_tpu.states import infinitemps as jimps
from mpskit_tpu.tensors import ops as jops
from mpskit_tpu_torch import (
    DMRG, VUMPS, InfiniteMPS, expectation_value, find_groundstate,
    heisenberg_XXX, transverse_field_ising_lattice,
)
from mpskit_tpu_torch.algorithms.vumps import _vumps_iteration_impl
from mpskit_tpu_torch.config import matmul_precision
from mpskit_tpu_torch.environments import infinite_ham as tinf
from mpskit_tpu_torch.interop import infinite_mps_from_numpy, mpo_from_numpy
from mpskit_tpu_torch.linalg import arnoldi as tarn
from mpskit_tpu_torch.linalg import gmres as tgm
from mpskit_tpu_torch.states import gauging as tgau
from mpskit_tpu_torch.tensors import ops as tops

torch.set_num_threads(1)

G = 1.5
# -(1/pi) int_0^pi sqrt(1 + g^2 - 2 g cos k) dk at g = 1.5: the energy
# density of H = -sum Z Z - g sum X (Gauss-Legendre, exact to 1e-15)
_k, _wk = np.polynomial.legendre.leggauss(200)
TFIM_E0 = float(-np.sum(_wk * np.sqrt(1 + G * G - 2 * G * np.cos(
    np.pi * (_k + 1) / 2))) / 2)


def _rand(rng, shape, dtype=np.float64):
    a = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _contraction(rng, n, radius, dtype):
    """A random n x n matrix of spectral radius `radius`."""
    T = _rand(rng, (n, n), dtype)
    return T * (radius / np.max(np.abs(np.linalg.eigvals(T))))


def _carry(pj, device="cpu"):
    return infinite_mps_from_numpy(np.asarray(pj.AL), np.asarray(pj.AR),
                                   np.asarray(pj.AC), np.asarray(pj.C),
                                   device)


def _carry_env(ej):
    return tinf.InfiniteHamEnv(_t(ej.GLs), _t(ej.GRs),
                               torch.tensor(float(ej.e_density)))


# the JAX environments under one jit: the same function, compiled once per
# shape instead of tracing each of its GMRES loops on every call
_jax_envs = jax.jit(jinf.hamiltonian_environments)


@functools.cache
def _jax_state(L, d, D):
    """A random complex128 state made by the JAX package (cached: its
    gauge fix compiles once per shape, and several tests share a state)."""
    return jimps.InfiniteMPS.random(jax.random.PRNGKey(10 * L + d), L, d, D)


def _models(name):
    """(port H, JAX H) with the same FSM."""
    if name == "tfim":
        Hj = jham.transverse_field_ising_lattice(g=G)
    else:
        Hj = jham.heisenberg_XXX(spin=1)
    return mpo_from_numpy(np.asarray(Hj.W)), Hj


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_linsolve_info_matches_jax(dtype):
    """(1 - T) x = b with T a random contraction: the solution and the
    true relative residual of both packages, and the solution of numpy."""
    rng = np.random.default_rng(0)
    n = 40
    T, b = _contraction(rng, n, 0.8, dtype), _rand(rng, n, dtype)
    Tt, Tj = _t(T), jnp.asarray(T)
    x_t, r_t = tgm.linsolve_info(lambda x: Tt @ x, _t(b), a0=1.0, a1=-1.0,
                                 tol=1e-12, restart=12, maxiter=40)
    x_j, r_j = jgm.linsolve_info(lambda x: Tj @ x, jnp.asarray(b), a0=1.0,
                                 a1=-1.0, tol=1e-12, restart=12, maxiter=40)
    x_np = np.linalg.solve(np.eye(n) - T, b)
    np.testing.assert_allclose(_np(x_t), np.asarray(x_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(_np(x_t), x_np, rtol=0, atol=1e-10)
    assert r_t <= 1e-12 and abs(r_t - float(r_j)) <= 1e-10


def test_gmres_float32_exits_on_the_stall_test():
    """An unreachable tolerance in float32: the solve stops on its stall
    tests near the dtype floor, far before maxiter, with a residual that
    only float32 rounding limits."""
    rng = np.random.default_rng(1)
    n = 64
    T = torch.from_numpy(_contraction(rng, n, 0.9, np.float64)).float()
    b = torch.from_numpy(rng.standard_normal(n)).float()
    x, relres, cycles = tgm.gmres_restarted(lambda v: v - T @ v, b, b,
                                            tol=1e-12, restart=12,
                                            maxiter=100, stall_exit=True)
    assert x.dtype == torch.float32
    assert 1e-12 < relres < 50 * np.sqrt(n) * np.finfo(np.float32).eps
    assert cycles <= 10
    # the same solve in float64 reaches the tolerance
    _, relres64, _ = tgm.gmres_restarted(lambda v: v - T.double() @ v,
                                         b.double(), b.double(), tol=1e-12,
                                         restart=12, maxiter=100,
                                         stall_exit=True)
    assert relres64 <= 1e-12


def test_dominant_eigs_matches_jax():
    rng = np.random.default_rng(2)
    n = 30
    A = rng.uniform(size=(n, n))
    v0 = rng.uniform(size=n)
    At, Aj = _t(A), jnp.asarray(A)
    res_t = tarn.dominant_eigs(lambda x: At @ x, _t(v0), 20, 50, 1e-12)
    res_j = jarn.dominant_eigs(lambda x: Aj @ x, jnp.asarray(v0), 20, 50,
                               1e-12)
    w = np.linalg.eigvals(A)
    assert res_t.converged
    assert abs(res_t.eigenvalue - float(res_j.eigenvalue)) <= 1e-10
    assert abs(res_t.eigenvalue - w[np.argmax(np.abs(w))].real) <= 1e-10
    x_t, x_j = _np(res_t.eigenvector), np.asarray(res_j.eigenvector)
    np.testing.assert_allclose(x_t * np.sign(x_t @ x_j), x_j, rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_regauge_and_batched_qr_match_jax(dtype):
    rng = np.random.default_rng(3)
    L, D, d = 3, 5, 2
    AC, C = _rand(rng, (L, D, d, D), dtype), _rand(rng, (L, D, D), dtype)
    M = AC.reshape(L, D * d, D)
    for tf, jf, X in ((tops.qr_pos, jops.qr_pos, M),
                      (tops.lq_pos, jops.lq_pos, M.transpose(0, 2, 1))):
        for a, b in zip(tf(_t(X)), jax.vmap(jf)(jnp.asarray(X))):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                       atol=1e-12)
    for tf, jf, args in ((tgau.regauge_ACC, jgau.regauge_ACC, (AC, C)),
                         (tgau.regauge_CAC, jgau.regauge_CAC, (C, AC))):
        ref = np.asarray(jax.vmap(jf)(*map(jnp.asarray, args)))
        np.testing.assert_allclose(_np(tf(*map(_t, args))), ref, rtol=0,
                                   atol=1e-12)
        # one site at a time gives the batch's result
        np.testing.assert_allclose(_np(tf(*(_t(a[1]) for a in args))),
                                   ref[1], rtol=0, atol=1e-12)


@pytest.mark.parametrize("L,d,D", [(1, 2, 6), (2, 3, 5)])
def test_infinite_mps_from_A_matches_jax(L, d, D):
    A = _rand(np.random.default_rng(4 + L), (L, D, d, D), np.complex128)
    pt = InfiniteMPS.from_A(_t(A))
    pj = jimps.InfiniteMPS.from_A(jnp.asarray(A))
    eye = np.eye(D)
    for i in range(L):
        np.testing.assert_allclose(
            np.linalg.svd(_np(pt.C[i]), compute_uv=False),
            np.linalg.svd(np.asarray(pj.C[i]), compute_uv=False),
            rtol=0, atol=1e-10)
        AL, AR = _np(pt.AL[i]), _np(pt.AR[i])
        ALC = np.einsum("lpm,mr->lpr", AL, _np(pt.C[i]))
        CAR = np.einsum("lm,mpr->lpr", _np(pt.C[(i - 1) % L]), AR)
        np.testing.assert_allclose(ALC, CAR, rtol=0, atol=1e-10)
        np.testing.assert_allclose(ALC, _np(pt.AC[i]), rtol=0, atol=1e-10)
        np.testing.assert_allclose(np.einsum("lpm,lpr->mr", AL.conj(), AL),
                                   eye, rtol=0, atol=1e-10)
        np.testing.assert_allclose(np.einsum("lpr,mpr->lm", AR, AR.conj()),
                                   eye, rtol=0, atol=1e-10)
    # the caps and the eight fixed points, on a state carried from JAX
    pc = _carry(pj)
    for name in ("rho_rights", "rho_lefts"):
        np.testing.assert_allclose(_np(getattr(pc, name)()),
                                   np.asarray(getattr(pj, name)()),
                                   rtol=0, atol=1e-14)
    for name in ("l_LL", "l_RR", "l_RL", "l_LR", "r_RR", "r_LL", "r_RL",
                 "r_LR"):
        for i in range(L):
            np.testing.assert_allclose(_np(getattr(pc, name)(i)),
                                       np.asarray(getattr(pj, name)(i)),
                                       rtol=0, atol=1e-14)
    X = _rand(np.random.default_rng(5), (d, d), np.complex128)
    X = X + X.conj().T
    np.testing.assert_allclose(
        complex(expectation_value(pc, (L - 1, X))),
        complex(jexp.expval_infinite_local(pj, X, L - 1)), rtol=0,
        atol=1e-12)
    assert pc.repeat(2).period == 2 * L


def test_block_transfers_match_jax():
    """The single-block transfers and the source terms of both walk
    directions against JAX, and the identity that lets the paired walk run
    the right walk in left form: the right forms equal the left forms on
    the leg-swapped tensor."""
    rng = np.random.default_rng(6)
    w, d, D = 5, 3, 4
    A = _rand(rng, (D, d, D), np.complex128)
    v, Wab = (_rand(rng, s, np.complex128) for s in ((D, D), (d, d)))
    G, Wc = (_rand(rng, s, np.complex128) for s in ((w, D, D), (w, d, d)))
    A_swap = A.transpose(2, 1, 0)
    for tf, jf, args in (
            (tinf.transfer_left_block, jinf.transfer_left_block,
             (v, Wab, A, A)),
            (tinf.transfer_right_block, jinf.transfer_right_block,
             (v, Wab, A, A)),
            (tinf._source_col_left, jinf._source_col_left, (G, Wc, A)),
            (tinf._source_row_right, jinf._source_row_right, (G, Wc, A))):
        np.testing.assert_allclose(_np(tf(*map(_t, args))),
                                   np.asarray(jf(*args)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        _np(tinf.transfer_right_block(_t(v), _t(Wab), _t(A), _t(A))),
        _np(tinf.transfer_left_block(_t(v), _t(Wab), _t(A_swap),
                                     _t(A_swap))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        _np(tinf._source_row_right(_t(G), _t(Wc), _t(A))),
        _np(tinf._source_col_left(_t(G), _t(Wc), _t(A_swap))), rtol=0,
        atol=1e-12)
    # a leading pair axis gives each member its own result
    pair = tinf.transfer_left_block(*(torch.stack([_t(x), _t(x)])
                                      for x in (v, Wab, A, A_swap)))
    np.testing.assert_allclose(
        _np(pair[1]), _np(tinf.transfer_left_block(_t(v), _t(Wab), _t(A),
                                                   _t(A_swap))),
        rtol=0, atol=1e-14)


@pytest.mark.parametrize("model", ["tfim", "spin1"])
@pytest.mark.parametrize("L", [1, 2, 3])
def test_hamiltonian_environments_match_jax(model, L):
    """Cold and warm-started (`env_init`) environments of a state carried
    from JAX: every GL and GR elementwise, and the energy density."""
    Ht, Hj = _models(model)
    d, D = Ht.physicaldim, 6
    pj = _jax_state(L, d, D)
    pt = _carry(pj)
    cold_j = _jax_envs(pj, Hj)
    cold_t = tinf.hamiltonian_environments(pt, Ht)
    warm_j = _jax_envs(pj, Hj, env_init=cold_j)
    warm_t = tinf.hamiltonian_environments(pt, Ht, env_init=cold_t)
    for et, ej in ((cold_t, cold_j), (warm_t, warm_j)):
        np.testing.assert_allclose(_np(et.GLs), np.asarray(ej.GLs), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(_np(et.GRs), np.asarray(ej.GRs), rtol=0,
                                   atol=1e-9)
        assert abs(float(et.e_density) - float(ej.e_density)) <= 1e-12
        assert et.resid <= 1e-9
    np.testing.assert_allclose(
        _np(expectation_value(pt, Ht, envs=cold_t)),
        np.asarray(jexp.expval_infinite_mpoham(pj, Hj, cold_j)), rtol=0,
        atol=1e-12)


@pytest.mark.parametrize("L,masked", [(1, False), (2, False), (1, True)])
def test_one_vumps_iteration_matches_jax(L, masked):
    """One iteration from the same carried state and environments; with
    `masked`, sector masks (here: the last bond direction switched off)
    applied after the solves, as the charge-sector paths do."""
    Ht, Hj = _models("tfim")
    m, restarts, inner_tol = 10, 20, 1e-12
    D = 6
    pj = _jax_state(L, 2, D)
    envs_j = _jax_envs(pj, Hj)
    masks = {}
    if masked:
        keep = np.arange(D) < D - 1
        masks = {"A_mask": np.broadcast_to(
                     keep[:, None, None] & keep[None, None, :],
                     (L, D, 2, D)).copy(),
                 "C_mask": np.broadcast_to(keep[:, None] & keep[None, :],
                                           (L, D, D)).copy()}
    qj, eps_j, ej, _ = jvumps._vumps_iteration(
        pj, Hj, m, restarts, 1e-12, 1e-12, inner_tol, env_guess=envs_j,
        **{k: jnp.asarray(v) for k, v in masks.items()})
    with matmul_precision():
        qt, eps_t, et, diag = _vumps_iteration_impl(
            _carry(pj), Ht, m, restarts, 1e-12, 1e-12, inner_tol,
            env_guess=_carry_env(envs_j),
            **{k: _t(v) for k, v in masks.items()})
    assert diag[0] == 0
    assert abs(float(eps_t) - float(eps_j)) <= 1e-10
    assert abs(float(et.e_density) - float(ej.e_density)) <= 1e-12
    for i in range(L):
        np.testing.assert_allclose(
            np.linalg.svd(_np(qt.C[i]), compute_uv=False),
            np.linalg.svd(np.asarray(qj.C[i]), compute_uv=False),
            rtol=0, atol=1e-8)


def test_find_groundstate_vumps_tfim_integral():
    """The JAX package's `test_vumps_tfim` oracle, on the port."""
    H = transverse_field_ising_lattice(g=G)
    gen = torch.Generator().manual_seed(0)
    psi = InfiniteMPS.random(1, 2, 12, device="cpu", generator=gen)
    psi, envs, eps = find_groundstate(psi, H, VUMPS(tol=1e-9, maxiter=150))
    assert eps < 1e-9
    assert abs(float(expectation_value(psi, H, envs=envs)[0]) - TFIM_E0) < 1e-7
    assert abs(float(envs.e_density) - TFIM_E0) < 1e-7


def test_spin1_heisenberg_iterations_match_jax():
    """Five iterations of spin-1 Heisenberg (w=5, d=3) in complex128 from
    the same carried state, environments carried through."""
    Ht, Hj = heisenberg_XXX(spin=1), jham.heisenberg_XXX(spin=1)
    pj = _jax_state(1, 3, 6)
    pt, et, ej = _carry(pj), None, None
    with matmul_precision():
        for _ in range(5):
            pj, _, ej, _ = jvumps._vumps_iteration(pj, Hj, 10, 4, 1e-12,
                                                   1e-12, 1e-10,
                                                   env_guess=ej)
            pt, _, et, _ = _vumps_iteration_impl(pt, Ht, 10, 4, 1e-12, 1e-12,
                                                 1e-10, env_guess=et)
    assert abs(float(et.e_density) - float(ej.e_density)) <= 1e-8
    e_t = float(expectation_value(pt, Ht)[0])
    e_j = float(jexp.expval_infinite_mpoham(pj, Hj)[0])
    assert abs(e_t - e_j) <= 1e-8


def test_device_batch_changes_nothing():
    """The port checks every iteration: device_batch=8 gives what 1 gives."""
    H = transverse_field_ising_lattice(g=G)
    psi = InfiniteMPS.random(1, 2, 6, torch.float64, "cpu",
                             torch.Generator().manual_seed(1))
    out = [find_groundstate(psi, H, VUMPS(tol=1e-9, maxiter=6,
                                          device_batch=nb, verbosity=0))
           for nb in (1, 8)]
    (_, e1, eps1), (_, e8, eps8) = out
    assert eps1 == eps8
    assert float(e1.e_density) == float(e8.e_density)


def test_find_groundstate_infinite_dispatch(monkeypatch):
    """The default tol (below VUMPS's 1e-9 floor) refines by
    GradientGrassmann(tol=tol) only where VUMPS stops above it; a
    ChainedAlg runs its stages; a finite-chain algorithm is refused. (The
    refinement itself is pinned against JAX in test_torch_grassmann.py.)"""
    import importlib

    from mpskit_tpu_torch import GradientGrassmann

    fgs = importlib.import_module(
        "mpskit_tpu_torch.algorithms.find_groundstate")

    H = transverse_field_ising_lattice(g=G)
    psi = InfiniteMPS.random(1, 2, 6, torch.float64, "cpu",
                             torch.Generator().manual_seed(2))
    calls = []

    def refine(psi, H, alg):
        calls.append(alg)
        return psi, None, 0.0

    monkeypatch.setattr(fgs, "find_groundstate_grassmann", refine)
    _, _, eps = find_groundstate(psi, H, maxiter=3, verbosity=0)
    assert eps == 0.0 and calls == [GradientGrassmann(tol=1e-10,
                                                      verbosity=0)]
    # tol >= 1e-9: VUMPS alone, no refinement, whatever eps it reaches
    _, _, eps = find_groundstate(psi, H, tol=1e-9, maxiter=3, verbosity=0)
    assert eps > 1e-9 and len(calls) == 1
    monkeypatch.undo()
    chained = VUMPS(maxiter=2, verbosity=0) & VUMPS(maxiter=2, verbosity=0)
    assert len(chained) == 2
    _, envs, eps = find_groundstate(psi, H, chained)
    assert np.isfinite(eps) and np.isfinite(float(envs.e_density))
    with pytest.raises(TypeError, match="DMRG does not run on InfiniteMPS"):
        find_groundstate(psi, H, DMRG())


def test_expectation_value_takes_envs_by_keyword():
    """F1: the JAX signature (psi, O, *args, envs=None). A random
    InfiniteMPS (period 1, D=4, complex128, JAX PRNGKey(1)) with
    `transverse_field_ising(g=1.3)`: a site range after the operator is
    the ranged energy, as in the JAX package (0.50408), and so is an int
    (to 1e-12 of the JAX values); envs passed by keyword give the density
    that the environments give."""
    Hj = jham.transverse_field_ising(g=1.3)
    Ht = mpo_from_numpy(np.asarray(Hj.W))
    pj = jimps.InfiniteMPS.random(jax.random.PRNGKey(1), 1, 2, 4)
    pt = _carry(pj)
    from mpskit_tpu.algorithms.expval import expectation_value as jexpval

    assert abs(float(jnp.real(jexpval(pj, Hj, range(0, 4)))) - 0.50408) \
        <= 1e-5
    for arg in (range(0, 4), 2):
        np.testing.assert_allclose(_np(expectation_value(pt, Ht, arg)),
                                   np.asarray(jexpval(pj, Hj, arg)), rtol=0,
                                   atol=1e-12)
    envs = tinf.hamiltonian_environments(pt, Ht)
    e_kw = _np(expectation_value(pt, Ht, envs=envs))
    np.testing.assert_allclose(e_kw, _np(tinf.hamiltonian_environments(
        pt, Ht).e_density)[None], rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        e_kw, np.asarray(jexp.expval_infinite_mpoham(pj, Hj)), rtol=0,
        atol=1e-12)
