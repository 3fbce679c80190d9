"""Expectation values, correlators, dense-state constructors and the
transfer matvecs of the PyTorch port against the JAX package, on the CPU.

States are made by the JAX package from a PRNGKey and carried across with
`interop`, operators are numpy arrays made from a seed; both packages then
compute from the same numbers in float64 / complex128. Every value here is
gauge-invariant, so the tolerance is rounding: 1e-12 absolute on values of
order 1 unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import correlators as jcor
from mpskit_tpu.algorithms import expval as jexp
from mpskit_tpu.models import hamiltonians as jh
from mpskit_tpu.operators.mpo import DenseMPO as JDenseMPO
from mpskit_tpu.states.finitemps import FiniteMPS as JFiniteMPS
from mpskit_tpu.states.infinitemps import InfiniteMPS as JInfiniteMPS
from mpskit_tpu.transfermatrix import transfer as jtr
from mpskit_tpu_torch import (
    FiniteMPS, correlator, expectation_value, infinite_temperature,
    string_correlator,
)
from mpskit_tpu_torch.interop import (
    dense_mpo_from_numpy, finite_mps_from_numpy, infinite_mps_from_numpy,
    mpo_from_numpy,
)
from mpskit_tpu_torch.models import hamiltonians as th
from mpskit_tpu_torch.transfermatrix import transfer as ttr

torch.set_num_threads(1)
C128 = jnp.complex128
TOL = 1e-12


def _finite(L=6, d=2, D=6, seed=0, dtype=C128):
    pj = JFiniteMPS.random(jax.random.PRNGKey(seed), L, d, D, dtype=dtype)
    pt = finite_mps_from_numpy(np.asarray(pj.ALs), np.asarray(pj.ARs),
                               np.asarray(pj.AC), pj.center, device="cpu")
    return pj, pt


def _infinite(L=2, d=2, D=5, seed=1, dtype=C128):
    pj = JInfiniteMPS.random(jax.random.PRNGKey(seed), L, d, D, dtype=dtype)
    pt = infinite_mps_from_numpy(*(np.asarray(x) for x in
                                   (pj.AL, pj.AR, pj.AC, pj.C)), "cpu")
    return pj, pt


def _ops(d, seed, n=1):
    """A random complex operator on n sites, shape (d,)*2n."""
    rng = np.random.default_rng(seed)
    D = d ** n
    M = rng.standard_normal((D, D)) + 1j * rng.standard_normal((D, D))
    return M.reshape((d,) * (2 * n)) if n > 1 else M


def _close(a, b, tol=TOL):
    a = a.resolve_conj().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("site", [0, 2, 5])
def test_finite_local_operator(site):
    pj, pt = _finite()
    O = _ops(2, site)
    _close(expectation_value(pt, (site, O)),
           jexp.expectation_value(pj, (site, O)))


@pytest.mark.parametrize("n,at,flat", [(2, 0, False), (2, 3, True),
                                       (3, 1, False), (3, 3, True)])
def test_finite_operator_string(n, at, flat):
    """n-site operators given as (d,)*2n or as a (d^n, d^n) matrix."""
    pj, pt = _finite(seed=2)
    O = _ops(2, 10 + n, n)
    if flat:
        O = O.reshape(2 ** n, 2 ** n)
    _close(expectation_value(pt, (at, O)), jexp.expectation_value(pj, (at, O)))


def test_finite_densempo():
    """A ragged finite DenseMPO (edge legs of size 1, w=3 in the bulk)
    and the product of one-site operators."""
    pj, pt = _finite(L=5, seed=3)
    rng = np.random.default_rng(4)
    shapes = [(1, 3), (3, 3), (3, 2), (2, 3), (3, 1)]
    Os = [rng.standard_normal((a, b, 2, 2)) + 1j * rng.standard_normal(
        (a, b, 2, 2)) for a, b in shapes]
    jO = JDenseMPO(tuple(jnp.asarray(o) for o in Os))
    _close(expectation_value(pt, dense_mpo_from_numpy(Os)),
           jexp.expectation_value(pj, jO))
    Z = np.diag([1.0, -1.0])
    par = JDenseMPO.from_array(jnp.asarray(Z)[None, None], period=5)
    _close(expectation_value(pt, dense_mpo_from_numpy(
        [np.asarray(o) for o in par.Os])), jexp.expectation_value(pj, par))


@pytest.mark.parametrize("n,at", [(1, 0), (2, 1), (3, 0), (3, 3)])
def test_infinite_local_and_string(n, at):
    pj, pt = _infinite()
    O = _ops(2, 20 + n, n)
    _close(expectation_value(pt, (at, O)), jexp.expectation_value(pj, (at, O)))


@pytest.mark.parametrize("rng", [range(0, 4), 3, range(1, 6), range(3, 4)])
def test_infinite_ranged_energy(rng):
    """expectation_value(psi, H, range | int) is the ranged energy, as in
    the JAX package (a period-2 TFIM cell, D=5)."""
    pj, pt = _infinite()
    Hj = jh.transverse_field_ising(g=1.3, period=2)
    Ht = mpo_from_numpy(np.asarray(Hj.W))
    _close(expectation_value(pt, Ht, rng),
           jexp.expectation_value(pj, Hj, rng), 1e-11)


def test_infinite_temperature():
    for Hj, Ht in ((jh.heisenberg_XXX(spin=1, period=2),
                    th.heisenberg_XXX(spin=1, period=2)),
                   (jh.transverse_field_ising(g=0.5),
                    th.transverse_field_ising(g=0.5))):
        jO, tO = jexp.infinite_temperature(Hj), infinite_temperature(Ht)
        assert tO.period == jO.period
        for a, b in zip(jO.Os, tO.Os):
            assert np.asarray(a).dtype == b.dtype
            assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("kind", ["finite", "infinite"])
def test_correlators(kind):
    """correlator and string_correlator, a list of sites and one site."""
    pj, pt = (_finite(L=7, D=8, seed=5) if kind == "finite"
              else _infinite(seed=6))
    O1, O2, Om = _ops(2, 30), _ops(2, 31), _ops(2, 32)
    js = [2, 3, 6]
    _close(correlator(pt, O1, O2, 1, js), jcor.correlator(pj, O1, O2, 1, js))
    _close(correlator(pt, O1, O2, 0, 4), jcor.correlator(pj, O1, O2, 0, 4))
    _close(string_correlator(pt, O1, Om, O2, 1, js),
           jcor.string_correlator(pj, O1, Om, O2, 1, js))
    _close(string_correlator(pt, O1, Om, O2, 2, 3),
           jcor.string_correlator(pj, O1, Om, O2, 2, 3))


def test_from_dense_add_and_mul():
    """FiniteMPS.from_dense of a random vector (L=7, d=2, truncated to
    D=4 and exact at D=8); the sum of two states and a scalar multiple:
    the tensors, overlaps and norms equal the JAX package's to 1e-12."""
    rng = np.random.default_rng(7)
    vec = rng.standard_normal(2 ** 7) + 1j * rng.standard_normal(2 ** 7)
    for D in (4, 8):
        fj = JFiniteMPS.from_dense(vec, 2, D)
        ft = FiniteMPS.from_dense(vec, 2, D, device="cpu")
        _close(ft.ARs, fj.ARs)
        _close(ft.AC, fj.AC)
    exact = FiniteMPS.from_dense(vec, 2, 8, device="cpu")
    ov = complex(exact.dot(exact))
    assert abs(ov - 1) <= 1e-12   # normalized on construction
    aj, at = _finite(L=7, D=3, seed=8)
    sj = aj + fj * (0.5 - 0.25j)
    st = at + ft * (0.5 - 0.25j)
    assert st.D == sj.D == 11
    _close(st.dot(st), sj.dot(sj))
    _close(st.dot(at), sj.dot(aj))
    _close((2.0 * at).dot(at), (2.0 * aj).dot(aj))
    _close(st.AC, sj.AC)


@pytest.mark.parametrize("side", ["left", "right"])
def test_mps_transfer_matvecs(side):
    """The unit-cell transfer matvecs, ket and bra from two cells (L=3) of
    random unnormalized tensors, to 1e-13 relative to the largest entry
    (the entries grow to ~1e3 over the cell)."""
    rng = np.random.default_rng(9)
    Ak = rng.standard_normal((3, 4, 2, 4)) + 1j * rng.standard_normal(
        (3, 4, 2, 4))
    Ab = rng.standard_normal((3, 4, 2, 4)) + 1j * rng.standard_normal(
        (3, 4, 2, 4))
    v = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    jmv = getattr(jtr, f"mps_transfer_matvec_{side}")(jnp.asarray(Ak),
                                                       jnp.asarray(Ab))
    tmv = getattr(ttr, f"mps_transfer_matvec_{side}")(torch.from_numpy(Ak),
                                                       torch.from_numpy(Ab))
    ref = np.asarray(jmv(jnp.asarray(v)))
    _close(tmv(torch.from_numpy(v)), ref, 1e-13 * np.abs(ref).max())


def test_unported_branches_name_their_slice():
    """The branches that item 10's window slice brought are wired: a time
    after a time-independent operator on a finite state is ignored, as in
    the JAX package (to 1e-12 of its value); the LazySum,
    MultipliedOperator, projection and window branches take their own
    types, so stand-ins that only carry those names, like other operator
    types, raise TypeError."""
    pj, pt = _finite()
    H = th.transverse_field_ising()
    Hj = jh.transverse_field_ising()
    _close(expectation_value(pt, H, 0.5), jexp.expectation_value(pj, Hj,
                                                                  0.5))
    for name in ("LazySum", "MultipliedOperator", "ProjectionOperator",
                 "LinearCombination"):
        with pytest.raises(TypeError):
            expectation_value(pt, type(name, (), {})())
    with pytest.raises(TypeError):
        expectation_value(type("WindowMPS", (), {})(), H)
    with pytest.raises(TypeError):
        expectation_value(pt, object())
