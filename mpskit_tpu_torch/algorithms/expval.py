"""Expectation values (counterpart of mpskit_tpu/algorithms/expval.py):
MPOHamiltonians, one-site operators, n-site operator strings and DenseMPOs
on finite and infinite states, the ranged infinite energy, LazySums,
(timed) MultipliedOperators, LinearCombinations, ProjectionOperators,
WindowMPSs, and `infinite_temperature`."""

from __future__ import annotations

import numpy as np
import torch

from ..environments.finite import (
    compute_right_envs, finite_environments, stack_W,
)
from ..operators.lazysum import LazySum, MultipliedOperator
from ..operators.mpo import DenseMPO, MPOHamiltonian, decompose_localmpo
from ..operators.projection import LinearCombination, ProjectionOperator
from ..states.finitemps import FiniteMPS
from ..states.infinitemps import InfiniteMPS
from ..states.windowmps import WindowMPS
from .derivatives import ac_apply
from .expval_infinite import (
    expval_infinite_densempo, expval_infinite_local, expval_infinite_mpoham,
    expval_infinite_ranged,
)

def _vdot(a, b):
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def _expval_finite_mpoham(psi: FiniteMPS, H: MPOHamiltonian, envs=None):
    if envs is None:
        envs = finite_environments(psi, H)
    c = psi.center
    W = stack_W(H, psi.length, psi.dtype, psi.device)[c]
    HAC = ac_apply(envs.leftenv(c), W, envs.rightenv(c), psi.AC)
    return (_vdot(psi.AC, HAC) / _vdot(psi.AC, psi.AC)).real


def _expval_finite_local(psi: FiniteMPS, O, site: int):
    """<O> of a one-site operator O (d, d) at `site` (a 0-dim tensor)."""
    p = psi.move_center(site)
    O = torch.as_tensor(np.asarray(O), device=p.device).to(p.dtype)
    num = torch.einsum("lsr,st,ltr->", p.AC.conj(), O, p.AC)
    return num / _vdot(p.AC, p.AC)


def _expval_finite_densempo(psi: FiniteMPS, O: DenseMPO):
    """<psi|O|psi> / <psi|psi> of a finite transfer MPO whose edge virtual
    legs may be ragged (size 1 at the ends): a host loop over the sites,
    whose shapes may differ."""
    p = psi.move_center(0)
    dt = torch.promote_types(p.dtype,
                             torch.from_numpy(np.asarray(O.site(0))).dtype)
    env = torch.zeros((p.D, O.site(0).shape[0], p.D), dtype=dt,
                      device=p.device)
    env[0, 0, 0] = 1.0
    for i in range(p.length):
        A = (p.AC if i == 0 else p.ARs[i]).to(dt)
        Oi = torch.from_numpy(np.asarray(O.site(i))).to(dtype=dt,
                                                         device=p.device)
        env = torch.einsum("xay,xsm,abst,ytn->mbn", env, A.conj(), Oi, A)
    return env[0, 0, 0] / _vdot(p.AC, p.AC)


def _string_step(v, A_ket, O, A_bra):
    """v (x_bra, k, y_ket) through one site of an MPO string
    O (k, s, t, k')."""
    t = torch.einsum("xky,ytn->xktn", v, A_ket)
    t = torch.einsum("xktn,kstK->xsKn", t, O.to(t.dtype))
    return torch.einsum("xsm,xsKn->mKn", A_bra.conj(), t)


def _expval_local_string(psi, O_nbody, at: int):
    """<O_{at..at+n-1}> of an n-site operator, given as (d,)*2n or
    (d^n, d^n): decomposed into an MPO string and walked through the
    left-gauged tensors. An infinite state closes with C at the last
    site; a finite one moves its center there and closes on AC."""
    O_nbody = np.asarray(O_nbody)
    d = psi.physicaldim
    if O_nbody.ndim == 2 and O_nbody.shape[0] > d:
        n = int(round(np.log(O_nbody.shape[0]) / np.log(d)))
        O_nbody = O_nbody.reshape((d,) * (2 * n))
    Os = [torch.from_numpy(np.ascontiguousarray(o)).to(psi.device)
          for o in decompose_localmpo(O_nbody)]
    n = len(Os)

    if isinstance(psi, InfiniteMPS):
        L = psi.period
        v = torch.eye(psi.D, dtype=psi.dtype, device=psi.device)[:, None, :]
        for j in range(n):
            A = psi.AL[(at + j) % L]
            v = _string_step(v, A, Os[j], A)
        C = psi.C[(at + n - 1) % L]
        return torch.einsum("xky,yc,xc->", v, C, C.conj())

    if at + n > psi.length:
        raise ValueError(f"an operator string of {n} sites at {at} exceeds "
                         f"the chain of {psi.length}")
    p = psi.move_center(at + n - 1)
    v = torch.eye(p.D, dtype=p.dtype, device=p.device)[:, None, :]
    for j in range(n - 1):
        A = p.ALs[at + j]
        v = _string_step(v, A, Os[j], A)
    # last site: AC on both layers; the AR gauge to its right closes the
    # walk to a trace over the final bond
    v = _string_step(v, p.AC, Os[n - 1], p.AC)
    return torch.einsum("mkm->k", v)[0] / _vdot(p.AC, p.AC)


def _is_local_string(op, d: int) -> bool:
    return np.ndim(op) > 2 or np.shape(op)[0] > d


def infinite_temperature(H) -> DenseMPO:
    """The identity density matrix as a host DenseMPO of H's period."""
    eye = np.eye(H.physicaldim, dtype=H.dtype)[None, None]
    return DenseMPO.from_array(eye, period=H.period)


def _expval_window_mpoham(psi: WindowMPS, H: MPOHamiltonian):
    """<H> of the window against the infinite sides' boundary environments
    (0-dim real tensor)."""
    win = psi.window.move_center(0)
    Ws = stack_W(H, win.length, win.dtype, win.device)
    GL0, GRL = psi.boundary_envs(H)
    GRs = compute_right_envs(win.ARs, Ws, GRL)
    HAC = ac_apply(GL0, Ws[0], GRs[1], win.AC)
    return (_vdot(win.AC, HAC) / _vdot(win.AC, win.AC)).real


def expectation_value(psi, O, *args, envs=None):
    """expectation_value(psi, H) for an MPOHamiltonian: <psi|H|psi> /
    <psi|psi> of a FiniteMPS (0-dim tensor), the per-site energy density
    of an InfiniteMPS ((L,) tensor), and with a site range or an int after
    it the energy of that window of an InfiniteMPS
    (`expval_infinite_ranged`); expectation_value(psi, (site, O)) for a
    one-site operator or, when O is (d,)*2n or (d^n, d^n), an n-site
    operator string starting at `site`; for a DenseMPO, <psi|O|psi> /
    <psi|psi> of a FiniteMPS and the leading transfer eigenvalue per site
    of an InfiniteMPS (a host number). Precomputed environments go by
    keyword, `envs=`, as in the JAX package.

    A LazySum gives the sum of its terms' values; a MultipliedOperator
    its coefficient at the time after it (default 0) times its operator's
    value; a LinearCombination the weighted sum; a ProjectionOperator
    |<ket|psi>|^2 / <psi|psi>. A WindowMPS takes local operators and
    strings on its window, and an MPOHamiltonian against the boundary
    environments of its infinite sides (the window's energy). A time after
    a time-independent operator on a finite state has nothing to change
    and is ignored, as in the JAX package."""
    if isinstance(O, LazySum):
        # the time goes on to the timed terms (the JAX package evaluates
        # them at 0 whatever the time)
        return sum(expectation_value(psi, o, *args) for o in O)
    if isinstance(O, MultipliedOperator):
        t = args[0] if args else 0.0
        return O.coeff(t) * expectation_value(psi, O.op)
    if isinstance(O, LinearCombination):
        return sum(c * expectation_value(psi, o)
                   for c, o in zip(O.coeffs, O.opps))
    if isinstance(O, ProjectionOperator):
        ov = O.ket.dot(psi)
        return ov.abs() ** 2 / psi.dot(psi).real
    if isinstance(psi, WindowMPS):
        if isinstance(O, tuple) and len(O) == 2:
            return expectation_value(psi.window, O)
        if isinstance(O, MPOHamiltonian):
            return _expval_window_mpoham(psi, O)
        raise TypeError(f"unsupported operator type {type(O)} for WindowMPS")
    if isinstance(psi, FiniteMPS):
        if isinstance(O, MPOHamiltonian):
            return _expval_finite_mpoham(psi, O, envs)
        if isinstance(O, DenseMPO):
            return _expval_finite_densempo(psi, O)
        if isinstance(O, tuple) and len(O) == 2:
            site, op = O
            if _is_local_string(op, psi.physicaldim):
                return _expval_local_string(psi, op, site)
            return _expval_finite_local(psi, op, site)
        raise TypeError(f"unsupported operator type {type(O)} for FiniteMPS")
    if isinstance(psi, InfiniteMPS):
        if isinstance(O, MPOHamiltonian):
            if args and isinstance(args[0], (range, int)):
                return expval_infinite_ranged(psi, O, args[0], envs)
            return expval_infinite_mpoham(psi, O, envs)
        if isinstance(O, DenseMPO):
            return expval_infinite_densempo(psi, O, envs)
        if isinstance(O, tuple) and len(O) == 2:
            site, op = O
            if _is_local_string(op, psi.physicaldim):
                return _expval_local_string(psi, op, site)
            return expval_infinite_local(psi, op, site)
        raise TypeError(f"unsupported operator type {type(O)} for "
                        "InfiniteMPS")
    raise TypeError(f"unsupported state type {type(psi)}")
