"""The boundary excitations of the PyTorch port (`excitations_boundary`,
the DenseMPO branch of `excitations`, the channel caps and the multi-row
solve) against the JAX package on the CPU.

The boundary states are made by the port (a few boundary VUMPS iterations
on the CPU) and carried into the JAX package as they are; the JAX start
vectors and null spaces are carried into the port by replacing
`LeftGaugedQP.random` in the port's module, so that both packages run one
eigenproblem from one start in one basis. As in test_torch_statmech.py,
the JAX side runs its dominant Ritz pair with the power iteration taken
to convergence (`jax_converged_ritz`), where the port solves it exactly
(ROADMAP.md, deliberate differences)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import excitations_statmech as jes
from mpskit_tpu.environments import infinite_mpo as jimpo
from mpskit_tpu.linalg import arnoldi as jarn
from mpskit_tpu.models import statmech as jmod
from mpskit_tpu.states.infinitemps import InfiniteMPS as JInfiniteMPS
from mpskit_tpu.states.quasiparticle import LeftGaugedQP as JLeftGaugedQP
from mpskit_tpu_torch import (
    InfiniteMPS, MPOMultiline, MPSMultiline, QuasiparticleAnsatz,
    VUMPS_Boundary, classical_ising, excitations, excitations_boundary,
    excitations_boundary_multiline, leading_boundary, sixvertex,
)
from mpskit_tpu_torch.algorithms import excitations_statmech as tes
from mpskit_tpu_torch.environments import infinite_mpo as timpo
from mpskit_tpu_torch.interop import left_gauged_qp_from_numpy

torch.set_num_threads(1)

_JAX_SMALL_EIG = jarn.small_eig_dominant
MOMENTA = (0.0, np.pi / 2)


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


def _boundary(O, L, D, seed, iters):
    """A port boundary state of O (complex128, CPU) after `iters` boundary
    VUMPS iterations, and the same arrays as a JAX InfiniteMPS."""
    psi = InfiniteMPS.random(L, 2, D, torch.complex128, "cpu",
                             torch.Generator().manual_seed(seed))
    psi, _, _ = leading_boundary(psi, O, VUMPS_Boundary(
        tol=1e-12, maxiter=iters, verbosity=0))
    arrays = [x.resolve_conj().numpy() for x in (psi.AL, psi.AR, psi.AC,
                                                  psi.C)]
    return psi, JInfiniteMPS(*(jnp.asarray(a) for a in arrays))


class _CarriedStarts:
    """Stands in for `LeftGaugedQP` in the port's module: `random` hands
    out the carried JAX start vectors in the order they are asked for."""

    def __init__(self, qps):
        self.qps = list(qps)

    def random(self, psi, momentum=0.0, right_gs=None, generator=None):
        qp = self.qps.pop(0)
        assert abs(qp.momentum - momentum) < 1e-15 and qp.left_gs is psi
        return qp


def _carry_qp(qj, psi_t):
    return left_gauged_qp_from_numpy(np.asarray(qj.Xs), np.asarray(qj.VLs),
                                     psi_t, qj.momentum)


@pytest.fixture(scope="module")
def sixvertex_state():
    """The six-vertex boundary (the reference's dispersion test, two-site
    cell) at D=6."""
    O = sixvertex()
    psi_t, psi_j = _boundary(O, 2, 6, 0, 12)
    return O, psi_t, psi_j


def test_channel_caps_and_pairing_match_jax(sixvertex_state,
                                            jax_converged_ritz):
    """The dominant pairs of the two mixed channels of the normalized MPO:
    the eigenvalue to 1e-12 and the pairing <l|r> = 1."""
    O, psi_t, psi_j = sixvertex_state
    Oj = jmod.sixvertex()
    et = timpo.mpo_environments(psi_t, O)
    ej = jimpo.mpo_environments(psi_j, Oj)
    assert abs(et.lambda_cell - complex(ej.lambda_cell)) <= 1e-12 * abs(
        et.lambda_cell)
    Ost = timpo.stack_O(O, 2, psi_t.dtype, "cpu") / et.lambda_cell ** 0.5
    Osj = jnp.stack([Oj.site(i) for i in range(2)]).astype(
        psi_j.dtype) / ej.lambda_cell ** 0.5
    for kb in ((0, 1), (1, 0)):
        ket_t, bra_t = (psi_t.AR, psi_t.AL)[kb[0]], (psi_t.AR, psi_t.AL)[kb[1]]
        ket_j, bra_j = (psi_j.AR, psi_j.AL)[kb[0]], (psi_j.AR, psi_j.AL)[kb[1]]
        lt, l_t, r_t = tes._channel_caps(Ost, ket_t, bra_t)
        lj, _, _ = jes._channel_caps(Osj, ket_j, bra_j, psi_j.dtype)
        assert abs(lt - complex(lj)) <= 1e-12
        assert abs(complex(tes.pairing(l_t, r_t)) - 1) <= 1e-12


def test_excitations_boundary_matches_jax(sixvertex_state,
                                          jax_converged_ritz):
    """The dominant excitation eigenvalue of the six-vertex boundary at p =
    0 and pi/2, from the JAX start vectors, to 1e-8; |lambda(0)| >
    |lambda(pi/2)| (the reference's dispersion oracle); the DenseMPO
    branch of `excitations` is the same solve."""
    O, psi_t, psi_j = sixvertex_state
    Oj = jmod.sixvertex()
    key = jax.random.PRNGKey(0)
    starts = [JLeftGaugedQP.random(key, psi_j, momentum=p) for p in MOMENTA]
    lam_j, _ = jes.excitations_boundary(Oj, list(MOMENTA), psi_j, key=key,
                                        tol=1e-10)
    envs = timpo.mpo_environments(psi_t, O)
    carried = [_carry_qp(q, psi_t) for q in starts]
    real = tes.LeftGaugedQP
    tes.LeftGaugedQP = _CarriedStarts(carried)
    try:
        lam_t, qps = excitations_boundary(O, list(MOMENTA), psi_t, envs=envs,
                                          tol=1e-10)
        tes.LeftGaugedQP = _CarriedStarts(carried)
        lam_e, _ = excitations(O, QuasiparticleAnsatz(), list(MOMENTA),
                               psi_t, envs=envs, tol=1e-10)
    finally:
        tes.LeftGaugedQP = real
    assert lam_t.shape == (2,) and lam_t.device.type == "cpu"
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=0,
                               atol=1e-8)
    assert torch.equal(lam_t, lam_e)
    assert abs(lam_t[0]) > abs(lam_t[1])
    assert [q.momentum for q in qps] == list(MOMENTA)


def test_excitations_boundary_seeded_start(sixvertex_state):
    """Without a generator every momentum starts from a generator seeded
    0: two runs agree exactly, and a seeded generator of the caller's is
    taken as it is."""
    O, psi_t, _ = sixvertex_state
    a, _ = excitations_boundary(O, 0.0, psi_t, tol=1e-8)
    b, _ = excitations_boundary(O, [0.0], psi_t, tol=1e-8)
    c, _ = excitations_boundary(O, [0.0], psi_t, tol=1e-8,
                                generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.equal(a, c)


def test_multiline_excitations_match_single_row(jax_converged_ritz):
    """Two identical rows of the off-critical (beta = 1.2) Ising boundary
    at D=6, p = 0.7: the coupled row-shifted operator is a cyclic
    permutation of identical blocks, so its dominant |lambda| is the
    single row's, here the JAX package's single-row solve, to 1e-8. (The
    coupled spectrum comes in +-mu pairs, which the port's exact Ritz
    solve resolves; the JAX power iteration cannot split such a pair, and
    its own multi-row test allows 1e-2.)"""
    O = classical_ising(beta=1.2)
    Oj = jmod.classical_ising(beta=1.2)
    psi_t, psi_j = _boundary(O, 1, 6, 1, 30)
    p = 0.7
    key = jax.random.PRNGKey(0)
    lam1, _ = jes.excitations_boundary(Oj, [p], psi_j, key=key, tol=1e-10)
    starts = [_carry_qp(JLeftGaugedQP.random(jax.random.fold_in(key, r),
                                             psi_j, momentum=p), psi_t)
              for r in range(2)]
    tes.LeftGaugedQP, real = _CarriedStarts(starts), tes.LeftGaugedQP
    try:
        lam2, qps = excitations_boundary_multiline(
            MPOMultiline.from_mpo(O, 2), [p], MPSMultiline.from_mps(psi_t, 2),
            tol=1e-10)
    finally:
        tes.LeftGaugedQP = real
    assert len(qps[0]) == 2 and np.isfinite(complex(lam2[0]))
    assert abs(abs(complex(lam2[0])) - abs(complex(lam1[0]))) <= 1e-8
    with pytest.raises(TypeError, match="MPSMultiline"):
        excitations_boundary_multiline(O, [p], psi_t)
