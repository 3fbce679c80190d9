"""The dense-projector SU(2) backend of the PyTorch port against the JAX
package on the CPU, float64: Clebsch-Gordan coefficients, the intertwiner
projectors, the SU(2)-projected VUMPS of the spin-1 Heisenberg chain with
its exactly degenerate Schmidt multiplets, and the Haldane gap on that
state. The JAX states are drawn from PRNGKeys and carried across with
`interop.su2_infinite_mps_from_numpy`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms.vumps import VUMPS as JVUMPS
from mpskit_tpu.models import heisenberg_XXX as jheisenberg_XXX
from mpskit_tpu.symmetry import su2 as jsu2
from mpskit_tpu_torch import VUMPS, heisenberg_XXX
from mpskit_tpu_torch.interop import su2_infinite_mps_from_numpy
from mpskit_tpu_torch.symmetry import su2 as tsu2

torch.set_num_threads(1)

# spin-1 Heisenberg energy density (fixture H = 4 * S.S)
E_EXACT = 4 * -1.401484038971


def test_clebsch_gordan_orthogonality():
    """The CG coefficients are orthonormal and equal the JAX package's."""
    for tj1, tj2 in ((1, 1), (2, 2), (2, 1), (3, 2)):
        for tJ in range(abs(tj1 - tj2), tj1 + tj2 + 1, 2):
            for tJp in range(abs(tj1 - tj2), tj1 + tj2 + 1, 2):
                for tM in range(-min(tJ, tJp), min(tJ, tJp) + 1, 2):
                    s = sum(
                        tsu2.clebsch_gordan2(tj1, tm1, tj2, tM - tm1, tJ, tM)
                        * tsu2.clebsch_gordan2(tj1, tm1, tj2, tM - tm1, tJp,
                                               tM)
                        for tm1 in range(-tj1, tj1 + 1, 2))
                    assert abs(s - (1.0 if tJ == tJp else 0.0)) < 1e-12
                    for tm1 in range(-tj1, tj1 + 1, 2):
                        args = (tj1, tm1, tj2, tM - tm1, tJ, tM)
                        assert abs(tsu2.clebsch_gordan2(*args)
                                   - jsu2.clebsch_gordan2(*args)) <= 1e-15


def test_projector_orthonormality():
    mult = ((1, 2), (3, 1))
    Q = tsu2.build_A_projector(tsu2.SU2Bond(mult), 2, tsu2.SU2Bond(mult))
    np.testing.assert_allclose(Q.T @ Q, np.eye(Q.shape[1]), atol=1e-12)
    np.testing.assert_allclose(
        Q, jsu2.build_A_projector(jsu2.SU2Bond(mult), 2, jsu2.SU2Bond(mult)),
        atol=1e-15)
    QC = tsu2.build_C_projector(tsu2.SU2Bond(mult))
    np.testing.assert_allclose(QC.T @ QC, np.eye(QC.shape[1]), atol=1e-12)
    np.testing.assert_allclose(QC, jsu2.build_C_projector(jsu2.SU2Bond(mult)),
                               atol=1e-15)
    assert tsu2.SU2Bond(mult).dim == 8 and tsu2.SU2Bond(mult).n_multiplets == 3


@functools.lru_cache(maxsize=None)
def _vumps(mult, tol, maxiter, seed=0):
    """The JAX package's SU(2)-projected VUMPS and the port's from the same
    carried start."""
    spj = jsu2.SU2InfiniteMPS.random(jax.random.PRNGKey(seed),
                                     jsu2.SU2Bond(mult), 2,
                                     dtype=jnp.float64)
    s = spj.state
    sp = su2_infinite_mps_from_numpy(
        *(np.asarray(x) for x in (s.AL, s.AR, s.AC, s.C)), mult, 2,
        device="cpu")
    outj, envsj, epsj = jsu2.find_groundstate_su2_vumps(
        spj, jheisenberg_XXX(spin=1.0, dtype=np.float64),
        JVUMPS(tol=tol, maxiter=maxiter))
    out, envs, eps = tsu2.find_groundstate_su2_vumps(
        sp, heisenberg_XXX(spin=1, dtype=np.float64),
        VUMPS(tol=tol, maxiter=maxiter))
    return (out, envs, eps), (outj, envsj, float(epsj))


def _check_vumps(mult, tol, maxiter, e_tol, seed=0):
    (out, envs, eps), (outj, envsj, epsj) = _vumps(mult, tol, maxiter, seed)
    assert eps < 10 * tol and epsj < 10 * tol
    e = float(envs.e_density)
    assert abs(e - float(envsj.e_density)) < 1e-10
    assert abs(e - E_EXACT) < e_tol
    ok, s_dense = tsu2.su2_dense_schmidt_degeneracies(out, atol=1e-9)
    assert ok, "dense Schmidt spectrum is not exactly multiplet-degenerate"
    spec, specj = tsu2.su2_schmidt_spectrum(out), \
        jsu2.su2_schmidt_spectrum(outj)
    assert set(spec) == set(specj) == {tj for tj, _ in mult}
    for k in spec:
        np.testing.assert_allclose(spec[k], specj[k], atol=1e-10)
    assert spec[1][0] == max(v[0] for v in spec.values())


def test_su2_vumps_spin1_heisenberg_small():
    """The projected VUMPS at dense D=8 from PRNGKey(1), the seed of the
    JAX package's own D=8 dense run (tests/test_su2_reduced.py): the
    energy density within 1e-10 of the JAX package's, exact multiplet
    degeneracies, the multiplet Schmidt values within 1e-10 of JAX's, the
    largest in the j=1/2 doublet. (From PRNGKey(0) the port stops at the
    stationary point -5.3807 at eps 7e-12, which the JAX package also
    reaches from other starts: ROADMAP.md, reference-side observations.)"""
    _check_vumps(((1, 2), (3, 1)), 1e-11, 300, 5e-2, seed=1)


@pytest.mark.slow
def test_su2_vumps_spin1_heisenberg():
    """The JAX test's size, dense D=22 (half-integer sectors only, the
    energy within 5e-4 of the exact density)."""
    _check_vumps(((1, 4), (3, 2), (5, 1)), 1e-9, 300, 5e-4)


def _haldane(mult, tol, maxiter, seed=0):
    from mpskit_tpu.algorithms.excitations import (
        QuasiparticleAnsatz as JQPA, excitations_infinite as jexc,
    )
    from mpskit_tpu_torch import QuasiparticleAnsatz, excitations

    (out, envs, _), (outj, envsj, _) = _vumps(mult, tol, maxiter, seed)
    es, _ = excitations(heisenberg_XXX(spin=1, dtype=np.float64),
                        QuasiparticleAnsatz(tol=1e-9), np.pi, out.state,
                        envs=envs, num=1)
    esj, _ = jexc(jheisenberg_XXX(spin=1.0, dtype=np.float64),
                  JQPA(tol=1e-9), np.pi, outj.state, envs=envsj, num=1)
    return float(es[0, 0]) / 4, float(esj[0, 0]) / 4


def test_su2_haldane_gap_small():
    """The quasiparticle gap at p=pi on the projected D=8 state: within
    1e-8 of the JAX package's on its own state."""
    gap, gapj = _haldane(((1, 2), (3, 1)), 1e-11, 300, seed=1)
    assert abs(gap - gapj) < 1e-8 and 0.3 < gap < 0.6


@pytest.mark.slow
def test_su2_haldane_gap():
    """The flagship oracle at dense D=48: the Haldane gap 0.41047925 at
    p=pi within 1e-4, and within 1e-8 of the JAX package's."""
    gap, gapj = _haldane(((1, 8), (3, 5), (5, 2)), 1e-9, 400)
    assert abs(gap - 0.41047925) < 1e-4 and abs(gap - gapj) < 1e-8
