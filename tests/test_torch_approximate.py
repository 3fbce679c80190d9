"""`approximate` (FitDMRG, FitDMRG2, FitIDMRG, FitIDMRG2, the VOMPS-style
infinite fit, the multi-row route and plain compression) and the
multi-row and MPO branches of `changebonds` in the PyTorch port, against
the JAX package on the CPU.

States are made by the JAX package in complex128 and carried across with
`interop`; both packages fit from the same start. The fitted states are
fixed only up to gauge and phase, so the tests compare fidelities with
the dense target (finite chains of 6 sites), the magnitude of the mixed
channel eigenvalue <psi| O |phi> per unit cell (infinite states) and
Schmidt values. As in test_torch_statmech.py, the JAX side runs its
dominant Ritz pair with the power iteration taken to convergence
(`jax_converged_ritz`), where the port solves it exactly (ROADMAP.md,
deliberate differences)."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms.changebonds import (
    OptimalExpand as JOptimalExpand, SvdCut as JSvdCut,
    changebonds as jchangebonds,
)
from mpskit_tpu.algorithms.statmech import VOMPS as JVOMPS
from mpskit_tpu.linalg import arnoldi as jarn
from mpskit_tpu.models import statmech as jmod
from mpskit_tpu.operators import mpo as jmpo
from mpskit_tpu.operators.multiline import MPOMultiline as JMPOMultiline
from mpskit_tpu.states.finitemps import FiniteMPS as JFiniteMPS
from mpskit_tpu.states.infinitemps import InfiniteMPS as JInfiniteMPS
from mpskit_tpu.states.multiline import MPSMultiline as JMPSMultiline
from mpskit_tpu.tensors.ops import truncdim as jtruncdim
from mpskit_tpu_torch import (
    VOMPS, FitDMRG, FitDMRG2, FitIDMRG, FitIDMRG2, MPOMultiline,
    MPSMultiline, OptimalExpand, SvdCut, approximate, changebonds,
    classical_ising, finite_classical_ising, mpo_to_mps, mps_to_mpo,
    truncdim,
)
from mpskit_tpu_torch.interop import (
    finite_mps_from_numpy, infinite_mps_from_numpy,
)

# the JAX package re-exports the function under the module's name
jap = importlib.import_module("mpskit_tpu.algorithms.approximate")
torch.set_num_threads(1)

_JAX_SMALL_EIG = jarn.small_eig_dominant
N = 6


@pytest.fixture
def jax_converged_ritz():
    """The JAX package's dominant Ritz pair by 5000 power steps in place of
    300, with the jit caches cleared on entry and exit."""
    jarn.small_eig_dominant = functools.partial(_JAX_SMALL_EIG, iters=5000)
    jax.clear_caches()
    try:
        yield
    finally:
        jarn.small_eig_dominant = _JAX_SMALL_EIG
        jax.clear_caches()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _carry_finite(pj):
    return finite_mps_from_numpy(_np(pj.ALs), _np(pj.ARs), _np(pj.AC),
                                 int(pj.center), "cpu")


def _carry(pj):
    return infinite_mps_from_numpy(_np(pj.AL), _np(pj.AR), _np(pj.AC),
                                   _np(pj.C), "cpu")


def _vector(psi):
    """The 2^L amplitudes of a finite MPS of either package."""
    p = psi.move_center(0)
    D = p.D
    tensors = [_np(p.AC)] + [_np(p.ARs[i]) for i in range(1, p.length)]
    acc = np.zeros((1, D), complex)
    acc[0, 0] = 1.0
    for A in tensors:
        acc = np.einsum("xl,lpr->xpr", acc, A).reshape(-1, D)
    return acc[:, 0]


def _row_matrix(O):
    """Dense matrix of a finite row MPO (left and right edge legs of size
    1, O[a, b, s, t])."""
    E = np.ones((1, 1, 1))
    for i in range(O.period):
        Oi = np.asarray(O.site(i))
        w_r, d = Oi.shape[1], Oi.shape[2]
        E = np.einsum("aST,abst->bSsTt", E, Oi).reshape(
            w_r, E.shape[1] * d, E.shape[1] * d)
    return E[0]


def _fidelity(psi, target):
    a, b = _vector(psi), target
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


def _schmidt(C):
    return np.sort(np.linalg.svd(_np(C), compute_uv=False))[::-1]


@pytest.mark.parametrize("alg", ["FitDMRG", "FitDMRG2", "compress"])
def test_finite_fits_match_jax(alg):
    """A finite Ising row applied to a random D=4 state, fitted at D=4
    (both packages fit at the target's width) from one random start, or
    the state itself re-fitted: the fidelity with the dense target, to
    1e-8 of the JAX package's."""
    O = finite_classical_ising(N)
    phi_j = JFiniteMPS.random(jax.random.PRNGKey(1), N, 2, 4)
    psi_j = JFiniteMPS.random(jax.random.PRNGKey(2), N, 2, 4)
    phi_t, psi_t = _carry_finite(phi_j), _carry_finite(psi_j)
    if alg == "compress":
        target = _vector(phi_j)
        out_j = jap.approximate(psi_j, phi_j, jap.FitDMRG(maxiter=20))
        out_t = approximate(psi_t, phi_t, FitDMRG(maxiter=20))
    else:
        target = _row_matrix(O) @ _vector(phi_j)
        cls_j, cls_t = {"FitDMRG": (jap.FitDMRG, FitDMRG),
                        "FitDMRG2": (jap.FitDMRG2, FitDMRG2)}[alg]
        out_j = jap.approximate(psi_j, (jmod.finite_classical_ising(N),
                                        phi_j), cls_j(maxiter=20))
        out_t = approximate(psi_t, (O, phi_t), cls_t(maxiter=20))
    f_j, f_t = _fidelity(out_j[0], target), _fidelity(out_t[0], target)
    assert out_t[0].AC.device.type == "cpu" and out_t[1] is None
    assert 0.5 < f_t <= 1 + 1e-12
    assert abs(f_t - f_j) <= 1e-8


@pytest.fixture(scope="module")
def infinite_pair():
    """A random two-site-cell target phi and a start psi at D=4 (JAX
    states), both packages' copies."""
    phi_j = JInfiniteMPS.random(jax.random.PRNGKey(3), 2, 2, 4)
    psi_j = JInfiniteMPS.random(jax.random.PRNGKey(4), 2, 2, 4)
    return phi_j, psi_j, _carry(phi_j), _carry(psi_j)


@pytest.mark.parametrize("alg", ["FitIDMRG", "FitIDMRG2", "VOMPS"])
def test_infinite_fits_match_jax(infinite_pair, alg, jax_converged_ritz):
    """The critical Ising MPO applied to phi, fitted at D=4 by IDMRG1,
    IDMRG2 and VOMPS-style updates from one start: |lambda| of the mixed
    channel <psi| O |phi> per cell and the boundary bond's Schmidt values
    to 1e-8 of the JAX package's."""
    phi_j, psi_j, phi_t, psi_t = infinite_pair
    cls_j, cls_t = {"FitIDMRG": (jap.FitIDMRG, FitIDMRG),
                    "FitIDMRG2": (jap.FitIDMRG2, FitIDMRG2),
                    "VOMPS": (JVOMPS, VOMPS)}[alg]
    out_j, envs_j, _ = jap.approximate(
        psi_j, (jmod.classical_ising(), phi_j), cls_j(maxiter=3, verbosity=0))
    out_t, envs_t, err = approximate(
        psi_t, (classical_ising(), phi_t), cls_t(maxiter=3, verbosity=0))
    assert np.isfinite(err) and out_t.D == 4
    assert abs(abs(envs_t.lambda_cell) - abs(complex(envs_j.lambda_cell))
               ) <= 1e-8 * abs(envs_t.lambda_cell)
    np.testing.assert_allclose(_schmidt(out_t.C[1]), _schmidt(out_j.C[1]),
                               atol=1e-8)


def test_multiline_fit_matches_jax(infinite_pair, jax_converged_ritz):
    """Two rows: row r of the MPO maps phi's row r onto psi's row r+1,
    each an IDMRG1 fit; per-row |lambda| to 1e-8 of the JAX package's, and
    the identity MPO when O is None."""
    phi_j, psi_j, phi_t, psi_t = infinite_pair
    phi2_j = JInfiniteMPS.random(jax.random.PRNGKey(5), 2, 2, 4)
    phi_m_j = JMPSMultiline((phi_j, phi2_j))
    phi_m_t = MPSMultiline((phi_t, _carry(phi2_j)))
    out_j, envs_j, _ = jap.approximate(
        JMPSMultiline.from_mps(psi_j, 2),
        (JMPOMultiline.from_mpo(jmod.classical_ising(), 2), phi_m_j),
        jap.FitIDMRG(maxiter=3, verbosity=0))
    out_t, envs_t, eps = approximate(
        MPSMultiline.from_mps(psi_t, 2),
        (MPOMultiline.from_mpo(classical_ising(), 2), phi_m_t),
        FitIDMRG(maxiter=3, verbosity=0))
    assert isinstance(out_t, MPSMultiline) and out_t.nrows == 2
    for r in range(2):
        assert abs(abs(envs_t[r].lambda_cell)
                   - abs(complex(envs_j[r].lambda_cell))) <= 1e-8
    out_t, _, _ = approximate(psi_t, MPSMultiline((phi_t, phi_t)),
                              FitIDMRG(maxiter=2, verbosity=0))
    assert isinstance(out_t, MPSMultiline) and out_t.rows[0].D == 4


@pytest.mark.parametrize("container", ["DenseMPO", "MPOMultiline"])
def test_mpo_svdcut_matches_jax(container, jax_converged_ritz):
    """SvdCut(truncdim(1)) of the Ising transfer MPO through the
    InfiniteMPS of its site tensors: the Schmidt values of the result's
    MPS form to 1e-10 of the JAX package's."""
    O, Oj = classical_ising(), jmod.classical_ising()
    if container == "MPOMultiline":
        out_t = changebonds(MPOMultiline.from_mpo(O, 2), SvdCut(truncdim(1)),
                            device="cpu")
        out_j = jchangebonds(JMPOMultiline.from_mpo(Oj, 2),
                             JSvdCut(jtruncdim(1)))
        assert isinstance(out_t, MPOMultiline) and out_t.nrows == 2
        out_t, out_j = out_t.rows[1], out_j.rows[1]
    else:
        out_t = changebonds(O, SvdCut(truncdim(1)), device="cpu")
        out_j = jchangebonds(Oj, JSvdCut(jtruncdim(1)))
    assert isinstance(out_t.site(0), np.ndarray)
    assert out_t.site(0).shape == tuple(np.asarray(out_j.site(0)).shape)
    mps_t = mpo_to_mps(out_t, "cpu")
    mps_j = jmpo.mpo_to_mps(out_j)
    np.testing.assert_allclose(_schmidt(mps_t.C[0]), _schmidt(mps_j.C[0]),
                               atol=1e-10)
    back = mps_to_mpo(mps_t, 2)
    np.testing.assert_allclose(_schmidt(mpo_to_mps(back, "cpu").C[0]),
                               _schmidt(mps_t.C[0]), atol=1e-12)


def test_multiline_changebonds_match_jax(jax_converged_ritz):
    """Two boundary rows at D=6: SvdCut(truncdim(3)) row by row (Schmidt
    values to 1e-10), and OptimalExpand(2) along the row-r two-site
    derivative in the mixed environments (D 6 -> 8, isometric AL,
    Schmidt values to 1e-5: each package adds its own 1e-6 noise to the
    new block)."""
    rows_j = tuple(JInfiniteMPS.random(jax.random.PRNGKey(10 + r), 1, 2, 6)
                   for r in range(2))
    psi_j = JMPSMultiline(rows_j)
    psi_t = MPSMultiline(tuple(_carry(p) for p in rows_j))
    cut_t = changebonds(psi_t, SvdCut(truncdim(3)))
    cut_j = jchangebonds(psi_j, JSvdCut(jtruncdim(3)))
    grown_t = changebonds(psi_t, classical_ising(), OptimalExpand(dims=2))
    grown_j = jchangebonds(psi_j, jmod.classical_ising(),
                           JOptimalExpand(dims=2))
    assert isinstance(cut_t, MPSMultiline) and isinstance(grown_t,
                                                          MPSMultiline)
    for r in range(2):
        np.testing.assert_allclose(_schmidt(cut_t.rows[r].C[0]),
                                   _schmidt(cut_j.rows[r].C[0]), atol=1e-10)
        g = grown_t.rows[r]
        assert g.D == 8
        AL = g.AL[0].reshape(-1, 8)
        assert float((AL.mH @ AL - torch.eye(8, dtype=AL.dtype)).abs().max()
                     ) <= 1e-10
        np.testing.assert_allclose(_schmidt(g.C[0]),
                                   _schmidt(grown_j.rows[r].C[0]), atol=1e-5)
