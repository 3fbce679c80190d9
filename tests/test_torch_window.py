"""Windows in the PyTorch port against the JAX package on the CPU:
`WindowMPS.from_infinite`, `grow`, `shrink` and its deviation, the
boundary environments, window DMRG, the window energy, variance and
entanglement spectrum, frozen and co-evolving window TDVP, and the
windows slice of chip_smoke.py's phase 18 at a small size through both
packages.

The infinite ground state is made once by the JAX package (VUMPS, TFIM
H = -sum ZZ - g sum X at g=1.5, D=8, complex128) and carried across with
`interop`; random windows come from a JAX PRNGKey. Every compared value
is gauge-invariant (energies, local expectation values, Schmidt values,
the variance) or, for `from_infinite`, a plain copy; the tolerance is
1e-10 where both packages compute the same numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import dmrg as jdmrg
from mpskit_tpu.algorithms import tdvp as jtdvp
from mpskit_tpu.algorithms import toolbox as jtb
from mpskit_tpu.algorithms.expval import expectation_value as jexpval
from mpskit_tpu.algorithms.vumps import VUMPS as JVUMPS
from mpskit_tpu.algorithms.vumps import find_groundstate_vumps
from mpskit_tpu.models import hamiltonians as jh
from mpskit_tpu.operators.lazysum import LazySum as JLazySum
from mpskit_tpu.operators.lazysum import TimedOperator as JTimed
from mpskit_tpu.operators.mpo import MPOHamiltonian as JMPO
from mpskit_tpu.operators.window import Window as JWindow
from mpskit_tpu.states.finitemps import FiniteMPS as JFiniteMPS
from mpskit_tpu.states.infinitemps import InfiniteMPS as JInfiniteMPS
from mpskit_tpu.states.windowmps import WindowMPS as JWindowMPS
from mpskit_tpu_torch import (
    DMRG, TDVP, LazySum, MPOHamiltonian, TimedOperator, Window, WindowMPS,
    entanglement_spectrum, entropy, expectation_value, find_groundstate,
    timestep, variance,
)
from mpskit_tpu_torch.interop import (
    infinite_mps_from_numpy, mpo_from_numpy, window_mps_from_numpy,
)

torch.set_num_threads(1)

G, D, L = 1.5, 8, 8
TOL = 1e-10
X = np.array([[0.0, 1.0], [1.0, 0.0]], complex)
Z = np.diag([1.0, -1.0]).astype(complex)
ZZ = np.einsum("st,uv->sutv", Z, Z)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _leaves_inf(p):
    return [np.asarray(x) for x in (p.AL, p.AR, p.AC, p.C)]


def _carry_window(wj):
    left = _leaves_inf(wj.left_gs)
    right = left if wj.right_gs is wj.left_gs else _leaves_inf(wj.right_gs)
    w = wj.window
    return window_mps_from_numpy(
        left, (np.asarray(w.ALs), np.asarray(w.ARs), np.asarray(w.AC),
               w.center), right, device="cpu")


def _local(psi, op, n, expval):
    """<op> at every site (one-site op) or bond (two-site op) of a window,
    real parts as a numpy array."""
    k = 1 if op.ndim == 2 else 2
    return np.array([complex(expval(psi, (i, op))).real
                     for i in range(n - k + 1)])


@pytest.fixture(scope="module")
def gs():
    """(pj, pt, Hj, Ht): the infinite ground state in both packages."""
    Hj = jh.transverse_field_ising_lattice(g=G, dtype=np.complex128)
    Ht = mpo_from_numpy(np.asarray(Hj.W))
    pj = JInfiniteMPS.random(jax.random.PRNGKey(0), 1, 2, D,
                             dtype=jnp.complex128)
    pj, _, _ = find_groundstate_vumps(pj, Hj, JVUMPS(tol=1e-11,
                                                     maxiter=300))
    pt = infinite_mps_from_numpy(*_leaves_inf(pj), device="cpu")
    return pj, pt, Hj, Ht


@pytest.fixture(scope="module")
def dmrg_pair(gs):
    """Window DMRG from a random window of L sites in both packages."""
    pj, _, Hj, Ht = gs
    fj = JFiniteMPS.random(jax.random.PRNGKey(4), L, 2, D,
                           dtype=jnp.complex128)
    wj = JWindowMPS(pj, fj, pj)
    wt = _carry_window(wj)
    rj, _, _ = jdmrg.find_groundstate_dmrg(wj, Hj,
                                           jdmrg.DMRG(tol=1e-10, maxiter=30))
    rt, envs, eps = find_groundstate(wt, Ht, DMRG(tol=1e-10, maxiter=30))
    assert envs is None and eps < 1e-10
    return rj, rt


@pytest.mark.parametrize("Dw", [None, D + 2])
def test_from_infinite(gs, Dw):
    """The window is a padded copy of the unit cell: tensors equal to
    JAX's, the energy JAX's to 1e-10, <X> at every site the infinite one."""
    pj, pt, Hj, Ht = gs
    wj = JWindowMPS.from_infinite(pj, L, Dw)
    wt = WindowMPS.from_infinite(pt, L, Dw, device="cpu")
    assert wt.length == len(wt) == L and wt.D == (Dw or D)
    assert wt.left_gs is wt.right_gs and wt.window.center == 0
    for a, b in ((wj.window.ALs, wt.window.ALs),
                 (wj.window.ARs, wt.window.ARs), (wj.window.AC, wt.window.AC)):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    e_j, e_t = float(jexpval(wj, Hj)), float(expectation_value(wt, Ht))
    assert abs(e_t - e_j) <= TOL * abs(e_j)
    x_inf = complex(expectation_value(pt, (0, X))).real
    np.testing.assert_allclose(_local(wt, X, L, expectation_value), x_inf,
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("grow,shrink", [((2, 1), (2, 1)), ((0, 1), (1, 0)),
                                         ((1, 0), (0, 1))])
def test_grow_and_shrink(gs, grow, shrink):
    """grow absorbs ground-state cells and shrink hands them back: the
    deviation is rounding, <X> at every site unchanged, and a grow on one
    edge with a shrink on the other (the co-moving window) matches JAX."""
    pj, pt, _, _ = gs
    wj, wt = (JWindowMPS.from_infinite(pj, L),
              WindowMPS.from_infinite(pt, L, device="cpu"))
    gj, gt = wj.grow(*grow), wt.grow(*grow)
    assert gt.length == L + sum(grow) and gt.window.center == grow[0]
    np.testing.assert_allclose(_local(gt, X, gt.length, expectation_value),
                               _local(gj, X, gt.length, jexpval), rtol=0,
                               atol=TOL)
    (sj, dev_j), (st, dev_t) = gj.shrink(*shrink), gt.shrink(*shrink)
    assert st.length == L + sum(grow) - sum(shrink)
    assert st.window.center == sj.window.center
    assert float(dev_t) < 1e-12 and float(dev_j) < 1e-12
    np.testing.assert_allclose(_local(st, X, st.length, expectation_value),
                               _local(sj, X, st.length, jexpval), rtol=0,
                               atol=TOL)
    with pytest.raises(ValueError):
        wt.shrink(L // 2, L - L // 2)


def test_boundary_envs(gs):
    """The padded boundary environments equal JAX's (one operator, and a
    different right operator with the infinite environments returned)."""
    pj, pt, Hj, Ht = gs
    wj, wt = (JWindowMPS.from_infinite(pj, L, D + 2),
              WindowMPS.from_infinite(pt, L, D + 2, device="cpu"))
    Hj2 = jh.transverse_field_ising_lattice(g=1.2, dtype=np.complex128)
    Ht2 = mpo_from_numpy(np.asarray(Hj2.W))
    GL0j, GRLj = wj.boundary_envs(Hj)
    GL0t, GRLt = wt.boundary_envs(Ht)
    for a, b in ((GL0j, GL0t), (GRLj, GRLt)):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0, atol=TOL)
    outj = wj.boundary_envs(Hj, H_right=Hj2, return_envs=True)
    outt = wt.boundary_envs(Ht, H_right=Ht2, return_envs=True)
    for a, b in zip(outj[:2], outt[:2]):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0, atol=TOL)
    assert abs(float(outt[3].e_density) - float(outj[3].e_density)) <= TOL
    # warm-started from the returned environments, the same fixed points
    again = wt.boundary_envs(Ht, H_right=Ht2, env_init=outt[2:])
    np.testing.assert_allclose(_np(again[1]), _np(outt[1]), rtol=0,
                               atol=TOL)


def test_window_dmrg(gs, dmrg_pair):
    """Window DMRG from a random window: energy and <X> at every site equal
    JAX's to 1e-10 and the infinite <X> to 1e-6 (the JAX test's bound)."""
    _, pt, Hj, Ht = gs
    rj, rt = dmrg_pair
    e_j, e_t = float(jexpval(rj, Hj)), float(expectation_value(rt, Ht))
    assert abs(e_t - e_j) <= TOL * abs(e_j)
    x_t = _local(rt, X, L, expectation_value)
    np.testing.assert_allclose(x_t, _local(rj, X, L, jexpval), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(x_t, complex(expectation_value(
        pt, (0, X))).real, rtol=0, atol=1e-6)
    np.testing.assert_allclose(_local(rt, ZZ, L, expectation_value),
                               _local(rj, ZZ, L, jexpval), rtol=0, atol=TOL)


def test_window_variance_and_spectrum(gs, dmrg_pair):
    """The window's two-site tangent variance, entanglement spectrum and
    entropy equal JAX's (the spectrum's values are well separated at
    g=1.5, so 1e-10 holds)."""
    _, _, Hj, Ht = gs
    rj, rt = dmrg_pair
    v_j, v_t = float(jtb.variance(rj, Hj)), float(variance(rt, Ht))
    assert v_t >= 0 and abs(v_t - v_j) <= TOL
    for bond in (None, 3):
        S_j = np.asarray(jtb.entanglement_spectrum(rj, bond))
        S_t = _np(entanglement_spectrum(rt, bond))
        np.testing.assert_allclose(S_t, S_j, rtol=0, atol=TOL)
        assert abs(float(entropy(rt, bond)) - float(jtb.entropy(rj, bond))) \
            <= TOL


@pytest.mark.parametrize("mode", ["frozen", "coevolving"])
def test_window_tdvp(gs, mode):
    """Two TDVP steps of the window under g=1.2 with frozen boundaries (a
    plain operator) and co-evolving ones (Window(H), environments threaded
    between steps): <X> at every site and the window norm equal JAX's."""
    pj, pt, _, _ = gs
    Hj1 = jh.transverse_field_ising_lattice(g=1.2, dtype=np.complex128)
    Ht1 = mpo_from_numpy(np.asarray(Hj1.W))
    opj, opt = (Hj1, Ht1) if mode == "frozen" else (JWindow(Hj1),
                                                     Window(Ht1))
    aj, at = (JWindowMPS.from_infinite(pj, L),
              WindowMPS.from_infinite(pt, L, device="cpu"))
    ej = et = None
    for _ in range(2):
        aj, ej = jtdvp.timestep(aj, opj, 0.0, 0.05, jtdvp.TDVP(), envs=ej)
        at, et = timestep(at, opt, 0.0, 0.05, TDVP(), envs=et)
    if mode == "frozen":
        assert et is None and at.left_gs is pt
    else:
        assert len(et) == 2 and at.left_gs is not pt
        np.testing.assert_allclose(
            _np(expectation_value(at.left_gs, (0, X))),
            np.asarray(jexpval(aj.left_gs, (0, X))), rtol=0, atol=TOL)
    np.testing.assert_allclose(_local(at, X, L, expectation_value),
                               _local(aj, X, L, jexpval), rtol=0, atol=TOL)
    assert abs(float(at.window.norm()) - 1) <= TOL


def _ramp(pkg_mpo):
    """H(t) = H_zz + f(t) H_x with f(t) = 1.5 - 0.6 t as the pieces of a
    LazySum: (H_zz, H_x)."""
    Hzz = pkg_mpo.from_local(-ZZ)
    Hx = pkg_mpo.from_local(-X)
    return Hzz, Hx


def _f(t):
    return 1.5 - 0.6 * t


@pytest.mark.parametrize("leg", ["a", "b"])
def test_window_slice_through_both_packages(gs, leg):
    """Phase 18's legs (a) and (b) at a small size. (a) window DMRG of L=8
    from a random window: <X_i> and <Z_i Z_i+1> within 1e-5 of the
    infinite values, the energy within 1e-5 relative of the from_infinite
    window's, grow(1, 1) then shrink(1, 1) with a deviation below 1e-5.
    (b) the co-evolving window TDVP of the field ramp H(t) = H_zz +
    f(t) H_x under Window(LazySum): the centre <X> and <ZZ> within 1e-4 of
    the port's infinite TDVP of the same LazySum at every step, the norm
    within 1e-5 of 1, and every value equal to the JAX package's to
    1e-10."""
    pj, pt, Hj, Ht = gs
    if leg == "a":
        fj = JFiniteMPS.random(jax.random.PRNGKey(9), L, 2, D,
                               dtype=jnp.complex128)
        wt = _carry_window(JWindowMPS(pj, fj, pj))
        rt, _, _ = find_groundstate(wt, Ht, DMRG(tol=1e-6, maxiter=12))
        x_inf = complex(expectation_value(pt, (0, X))).real
        zz_inf = complex(expectation_value(pt, (0, ZZ))).real
        assert np.abs(_local(rt, X, L, expectation_value) - x_inf).max() \
            <= 1e-5
        assert np.abs(_local(rt, ZZ, L, expectation_value) - zz_inf).max() \
            <= 1e-5
        e_ref = float(expectation_value(WindowMPS.from_infinite(
            pt, L, device="cpu"), Ht))
        assert abs(float(expectation_value(rt, Ht)) - e_ref) <= \
            1e-5 * abs(e_ref)
        back, dev = rt.grow(1, 1).shrink(1, 1)
        assert float(dev) <= 1e-5
        np.testing.assert_allclose(_local(back, X, L, expectation_value),
                                   _local(rt, X, L, expectation_value),
                                   rtol=0, atol=1e-6)
        return
    Hzz_j, Hx_j = _ramp(JMPO)
    Hzz_t, Hx_t = _ramp(MPOHamiltonian)
    Hs_j = JLazySum([Hzz_j, JTimed(Hx_j, _f)])
    Hs_t = LazySum([Hzz_t, TimedOperator(Hx_t, _f)])
    c = L // 2
    wj, wt = (JWindowMPS.from_infinite(pj, L),
              WindowMPS.from_infinite(pt, L, device="cpu"))
    ej = et = ie = None
    inf = pt
    for k in range(3):
        t = 0.05 * k
        wj, ej = jtdvp.timestep(wj, JWindow(Hs_j), t, 0.05, jtdvp.TDVP(),
                                envs=ej)
        wt, et = timestep(wt, Window(Hs_t), t, 0.05, TDVP(), envs=et)
        inf, ie = timestep(inf, Hs_t, t, 0.05, TDVP(), envs=ie)
        for op in (X, ZZ):
            v_t = complex(expectation_value(wt, (c, op))).real
            assert abs(v_t - complex(jexpval(wj, (c, op))).real) <= TOL
            assert abs(v_t - complex(expectation_value(inf, (0, op))).real) \
                <= 1e-4
        assert abs(float(wt.window.norm()) - 1) <= 1e-5
