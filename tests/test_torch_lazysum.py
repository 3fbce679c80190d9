"""Lazy sums, scaled and timed operators, projections and linear
combinations in the PyTorch port against the JAX package on the CPU: the
operator algebra, the termwise LazySum environments and derivatives
(finite and infinite, with a TimedOperator) against the materialized sum,
every new branch of `expectation_value`, and `find_groundstate`,
`timestep` and `variance` on a LazySum against the materialized H(t).

States are made by the JAX package from a PRNGKey and carried across with
`interop`; both packages then compute from the same numbers in
complex128. The tolerance is 1e-10 on gauge-invariant values (energies,
local expectation values, overlaps) and on the derivative applications,
which both packages compute from the same environments."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import tdvp as jtdvp
from mpskit_tpu.algorithms import toolbox as jtb
from mpskit_tpu.algorithms.dmrg import DMRG as JDMRG
from mpskit_tpu.algorithms.expval import expectation_value as jexpval
from mpskit_tpu.algorithms.find_groundstate import find_groundstate as jfind
from mpskit_tpu.environments import lazysum_env as jls
from mpskit_tpu.operators import lazysum as jlazy
from mpskit_tpu.operators.mpo import MPOHamiltonian as JMPO
from mpskit_tpu.operators.projection import (
    LinearCombination as JLinComb, ProjectionOperator as JProj,
)
from mpskit_tpu.states.finitemps import FiniteMPS as JFiniteMPS
from mpskit_tpu.states.infinitemps import InfiniteMPS as JInfiniteMPS
from mpskit_tpu_torch import (
    DMRG, TDVP, LazySum, LinearCombination, MPOHamiltonian,
    MultipliedOperator, ProjectionOperator, TimedOperator, UntimedOperator,
    Window, expectation_value, find_groundstate, lazysum_ac_apply,
    lazysum_c_apply, lazysum_environments, timestep, variance,
)
from mpskit_tpu_torch.algorithms.derivatives import ac_apply, c_apply
from mpskit_tpu_torch.environments.finite import finite_environments, \
    stack_W
from mpskit_tpu_torch.environments.infinite_ham import \
    hamiltonian_environments
from mpskit_tpu_torch.interop import (
    finite_mps_from_numpy, infinite_mps_from_numpy,
)

torch.set_num_threads(1)

TOL = 1e-10
G = 1.3
X = np.array([[0.0, 1.0], [1.0, 0.0]], complex)
Z = np.diag([1.0, -1.0]).astype(complex)
ZZ = np.einsum("st,uv->sutv", Z, Z)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _f(t):
    return G * math.cos(t)


def _sums():
    """H(t) = -sum ZZ + g cos(t) (-sum X) as a LazySum in each package,
    with its two terms."""
    out = {}
    for key, mpo, lazy, timed in (("jax", JMPO, jlazy.LazySum,
                                   jlazy.TimedOperator),
                                  ("torch", MPOHamiltonian, LazySum,
                                   TimedOperator)):
        Hzz, Hx = mpo.from_local(-ZZ), mpo.from_local(-X)
        out[key] = (lazy([Hzz, timed(Hx, _f)]), Hzz, Hx)
    return out


def _finite(seed=0, L=6, D=6, center=2):
    pj = JFiniteMPS.random(jax.random.PRNGKey(seed), L, 2, D,
                           dtype=jnp.complex128).move_center(center)
    pt = finite_mps_from_numpy(np.asarray(pj.ALs), np.asarray(pj.ARs),
                               np.asarray(pj.AC), pj.center, device="cpu")
    return pj, pt


def _infinite(seed=1, D=6):
    pj = JInfiniteMPS.random(jax.random.PRNGKey(seed), 1, 2, D,
                             dtype=jnp.complex128)
    pt = infinite_mps_from_numpy(*(np.asarray(x) for x in
                                   (pj.AL, pj.AR, pj.AC, pj.C)), "cpu")
    return pj, pt


def test_operator_algebra():
    """MultipliedOperator's coeff / eval_at / `*`, LazySum's indexing,
    call, `+`, `*`, is_timed and sum_materialized, and Window's
    broadcasting give the FSMs the JAX package gives."""
    sj, sz = _sums()["jax"], _sums()["torch"]
    Hs_j, Hzz_j, Hx_j = sj
    Hs_t, Hzz_t, Hx_t = sz
    assert Hs_t.is_timed and len(Hs_t) == 2 and Hs_t[0] is Hzz_t
    assert not Hs_t(0.4).is_timed and list(Hs_t)[1].is_timed
    for t in (0.0, 0.4):
        np.testing.assert_allclose(Hs_t(t).sum_materialized().W,
                                   np.asarray(Hs_j(t).sum_materialized().W),
                                   rtol=0, atol=1e-15)
        np.testing.assert_allclose(Hs_t.sum_materialized(t).W,
                                   Hs_t(t).sum_materialized().W, rtol=0,
                                   atol=1e-15)
    m_t = 2.0 * TimedOperator(Hx_t, _f)
    assert m_t.is_timed and abs(m_t.coeff(0.3) - 2 * _f(0.3)) < 1e-15
    u_t = UntimedOperator(Hx_t, 0.5) * 3.0
    assert not u_t.is_timed and u_t.coeff(9.0) == 1.5
    u_j = jlazy.UntimedOperator(Hx_j, 0.5) * 3.0
    np.testing.assert_array_equal(u_t.eval_at().W, np.asarray(u_j.eval_at().W))
    for a, b in (((Hs_t + Hzz_t) * 2.0, (Hs_j + Hzz_j) * 2.0),
                 (Hzz_t + Hs_t, Hzz_j + Hs_j), (Hs_t + Hs_t, Hs_j + Hs_j)):
        assert len(a) == len(b)
        np.testing.assert_allclose(a.sum_materialized(0.2).W,
                                   np.asarray(b.sum_materialized(0.2).W),
                                   rtol=0, atol=1e-15)
    w = Window(Hzz_t)
    assert w.left is w.middle is w.right is Hzz_t
    w2 = w.map(lambda O: O * 2.0)
    for O in (w2.left, w2.middle, w2.right):
        np.testing.assert_array_equal(O.W, (Hzz_t * 2.0).W)
    assert Window(Hzz_t, Hx_t, Hzz_t).middle is Hx_t
    with pytest.raises(ValueError):
        Window(Hzz_t, Hx_t)


@pytest.mark.parametrize("kind", ["finite", "infinite"])
def test_termwise_derivatives(kind):
    """lazysum_ac_apply / lazysum_c_apply at t = 0.7 equal the JAX
    package's; on a finite state they equal the derivatives of the
    materialized H(0.7), on an infinite one the summands' energies add up
    to the materialized sum's (the infinite environments carry
    regularized constants); a warm start from `prev` gives the same
    environments."""
    t = 0.7
    Hs_j = _sums()["jax"][0]
    Hs_t = _sums()["torch"][0]
    pj, pt = _finite() if kind == "finite" else _infinite()
    i = pt.center if kind == "finite" else 0
    AC_j = pj.AC if kind == "finite" else pj.AC[0]
    AC_t = pt.AC if kind == "finite" else pt.AC[0]
    rng = np.random.default_rng(3)
    Cx = rng.standard_normal((pt.D, pt.D)) + 1j * rng.standard_normal(
        (pt.D, pt.D))
    mj = jls.lazysum_environments(pj, Hs_j, t=t)
    mt = lazysum_environments(pt, Hs_t, t=t)
    assert mt.coeffs(Hs_t, t) == (1.0, _f(t))
    y_t = lazysum_ac_apply(mt, Hs_t, t, i, AC_t)
    c_t = lazysum_c_apply(mt, Hs_t, t, i - 1 if kind == "finite" else 0,
                          torch.from_numpy(Cx))
    np.testing.assert_allclose(_np(y_t), np.asarray(
        jls.lazysum_ac_apply(mj, Hs_j, t, i, AC_j)), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(c_t), np.asarray(
        jls.lazysum_c_apply(mj, Hs_j, t, i - 1 if kind == "finite" else 0,
                            jnp.asarray(Cx))), rtol=0, atol=TOL)
    Hm = Hs_t(t).sum_materialized()
    if kind == "finite":
        env = finite_environments(pt, Hm)
        W = stack_W(Hm, pt.length, pt.dtype, "cpu")[i]
        np.testing.assert_allclose(
            _np(y_t), _np(ac_apply(env.leftenv(i), W, env.rightenv(i),
                                   AC_t)), rtol=0, atol=TOL)
        np.testing.assert_allclose(
            _np(c_t), _np(c_apply(env.GLs[i], env.rightenv(i - 1),
                                  torch.from_numpy(Cx))), rtol=0, atol=TOL)
    else:
        e_terms = sum(c * float(e.e_density) for c, e in
                      zip(mt.coeffs(Hs_t, t), mt.envs))
        e_sum = float(hamiltonian_environments(pt, Hm).e_density)
        assert abs(e_terms - e_sum) <= TOL
        warm = lazysum_environments(pt, Hs_t, t=t, prev=mt)
        for a, b in zip(warm.envs, mt.envs):
            np.testing.assert_allclose(_np(a.GLs), _np(b.GLs), rtol=0,
                                       atol=TOL)


@pytest.mark.parametrize("branch", ["lazysum", "multiplied",
                                    "multiplied_infinite",
                                    "linear_combination", "projection"])
def test_expectation_value_branches(branch):
    """Each new branch of expectation_value against the JAX package's."""
    Hs_j, Hzz_j, Hx_j = _sums()["jax"]
    Hs_t, Hzz_t, Hx_t = _sums()["torch"]
    pj, pt = _finite()
    if branch == "lazysum":
        pairs = [(expectation_value(pt, Hs_t), jexpval(pj, Hs_j))]
        # the port passes a time on to the timed terms
        assert abs(complex(expectation_value(pt, Hs_t, 0.4))
                   - complex(expectation_value(
                       pt, Hs_t(0.4).sum_materialized()))) <= TOL
    elif branch == "multiplied":
        m_t, m_j = TimedOperator(Hx_t, _f), jlazy.TimedOperator(Hx_j, _f)
        pairs = [(expectation_value(pt, m_t, 0.4), jexpval(pj, m_j, 0.4)),
                 (expectation_value(pt, m_t), jexpval(pj, m_j)),
                 (expectation_value(pt, Hzz_t, 0.4), jexpval(pj, Hzz_j))]
    elif branch == "multiplied_infinite":
        ij, it = _infinite()
        m_t, m_j = TimedOperator(Hx_t, _f), jlazy.TimedOperator(Hx_j, _f)
        pairs = [(expectation_value(it, m_t, 0.4), jexpval(ij, m_j, 0.4)),
                 (expectation_value(it, Hs_t), jexpval(ij, Hs_j))]
    elif branch == "linear_combination":
        c = (0.5, -1.5 + 0.25j)
        pairs = [(expectation_value(pt, LinearCombination((Hzz_t, Hx_t), c)),
                  jexpval(pj, JLinComb((Hzz_j, Hx_j), c)))]
    else:
        kj, kt = _finite(seed=5)
        pairs = [(expectation_value(pt, ProjectionOperator(kt)),
                  jexpval(pj, JProj(kj))),
                 (expectation_value(pt, ProjectionOperator(pt)),
                  jexpval(pj, JProj(pj)))]
        assert abs(float(pairs[1][0]) - 1) <= TOL
    for a, b in pairs:
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=TOL)


@pytest.mark.parametrize("op", ["lazysum", "multiplied"])
def test_find_groundstate_materializes(op):
    """find_groundstate on a LazySum (MultipliedOperator) runs DMRG on
    sum_materialized() (eval_at(0)): the same state as the materialized
    operator in the port, the JAX package's energy to 1e-10."""
    Hs_j, _, Hx_j = _sums()["jax"]
    Hs_t, _, Hx_t = _sums()["torch"]
    if op == "multiplied":
        Hs_j = jlazy.UntimedOperator(Hs_j.sum_materialized(), 0.5)
        Hs_t = UntimedOperator(Hs_t.sum_materialized(), 0.5)
        Hm = Hs_t.eval_at(0.0)
    else:
        Hm = Hs_t.sum_materialized()
    pj, pt = _finite(seed=2, center=0)
    out, _, _ = find_groundstate(pt, Hs_t, DMRG(tol=1e-10, maxiter=20))
    ref, _, _ = find_groundstate(pt, Hm, DMRG(tol=1e-10, maxiter=20))
    np.testing.assert_array_equal(_np(out.AC), _np(ref.AC))
    oj, _, _ = jfind(pj, Hs_j, JDMRG(tol=1e-10, maxiter=20))
    e_j = float(jexpval(oj, Hs_j.sum_materialized() if op == "lazysum"
                        else Hs_j.eval_at(0.0)))
    assert abs(float(expectation_value(out, Hm)) - e_j) <= TOL * abs(e_j)


@pytest.mark.parametrize("kind", ["finite", "infinite"])
def test_timestep_at_the_midpoint(kind):
    """timestep on a LazySum with a TimedOperator evolves under
    H(t + dt/2): the same tensors as the materialized operator in the
    port, <X> and <ZZ> equal to the JAX package's LazySum step."""
    Hs_j = _sums()["jax"][0]
    Hs_t, _, Hx_t = _sums()["torch"]
    t, dt = 0.3, 0.05
    pj, pt = _finite() if kind == "finite" else _infinite()
    outj, _ = jtdvp.timestep(pj, Hs_j, t, dt, jtdvp.TDVP())
    out, _ = timestep(pt, Hs_t, t, dt, TDVP())
    ref, _ = timestep(pt, Hs_t(t + dt / 2).sum_materialized(), t, dt, TDVP())
    got = out.AC if kind == "finite" else out.AL
    np.testing.assert_array_equal(_np(got), _np(ref.AC if kind == "finite"
                                                else ref.AL))
    for site, op in ((1, X), (2, ZZ)):
        assert abs(complex(expectation_value(out, (site, op)))
                   - complex(jexpval(outj, (site, op)))) <= TOL
    m_out, _ = timestep(pt, TimedOperator(Hx_t, _f), t, dt, TDVP())
    m_ref, _ = timestep(pt, Hx_t * _f(t + dt / 2), t, dt, TDVP())
    np.testing.assert_array_equal(_np(m_out.AC), _np(m_ref.AC))


@pytest.mark.parametrize("kind", ["finite", "infinite"])
def test_variance_of_a_lazysum(kind):
    """variance of a LazySum (MultipliedOperator) is the variance of
    sum_materialized() (eval_at(0)), the JAX package's to 1e-10."""
    Hs_j = _sums()["jax"][0]
    Hs_t = _sums()["torch"][0]
    pj, pt = _finite() if kind == "finite" else _infinite()
    v_t = float(variance(pt, Hs_t))
    assert abs(v_t - float(variance(pt, Hs_t.sum_materialized()))) <= TOL
    assert abs(v_t - float(jtb.variance(pj, Hs_j))) <= TOL * max(1, v_t)
    m = MultipliedOperator(Hs_t.sum_materialized(), 2.0)
    assert abs(float(variance(pt, m)) - float(variance(
        pt, m.eval_at(0.0)))) <= TOL
