"""Carry state over from numpy arrays, e.g. `np.asarray` of the leaves of
a state or MPO made by the JAX package, so that both packages compute from
the same numbers (their random generators differ)."""

from __future__ import annotations

import numpy as np
import torch

from .operators.mpo import DenseMPO, MPOHamiltonian
from .states.finitemps import FiniteMPS
from .states.infinitemps import InfiniteMPS
from .states.quasiparticle import FiniteQP, LeftGaugedQP
from .states.windowmps import WindowMPS
from .symmetry.anyonic import AnyonicInfiniteMPS
from .symmetry.anyonic_finite import AnyonicFiniteMPS
from .symmetry.category import BraidedCategory, FusionCategory
from .symmetry.fibonacci import FibonacciInfiniteMPS
from .symmetry.multiplicity import (
    BraidedMultiplicityCategory, MultiplicityCategory,
)
from .symmetry.charges import SymmetricFiniteMPS, SymmetricInfiniteMPS
from .symmetry.su2 import SU2Bond, SU2InfiniteMPS
from .symmetry.su2_finite import SU2FiniteMPS
from .symmetry.su2_reduced import RBlocks, SU2ReducedState


def finite_mps_from_numpy(ALs, ARs, AC, center: int,
                          device="cuda") -> FiniteMPS:
    """FiniteMPS from stacked (L, D, d, D) ALs/ARs and a (D, d, D) AC, on
    the card unless `device` says otherwise."""
    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return FiniteMPS(t(ALs), t(ARs), t(AC), int(center))


def infinite_mps_from_numpy(AL, AR, AC, C, device="cuda") -> InfiniteMPS:
    """InfiniteMPS from stacked (L, D, d, D) AL/AR/AC and (L, D, D) C, on the
    card unless `device` says otherwise. The arrays are taken as they are:
    no gauge fix runs."""
    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return InfiniteMPS(t(AL), t(AR), t(AC), t(C))


def window_mps_from_numpy(left, window, right, device="cuda") -> WindowMPS:
    """WindowMPS from the numpy leaves of a JAX WindowMPS: left and right
    are (AL, AR, AC, C) of the infinite sides, window is (ALs, ARs, AC,
    center); on the card unless `device` says otherwise. A right side
    given as the very same tuple as the left one is the same InfiniteMPS,
    as in `WindowMPS.from_infinite`."""
    left_gs = infinite_mps_from_numpy(*left, device=device)
    right_gs = (left_gs if right is left
                else infinite_mps_from_numpy(*right, device=device))
    return WindowMPS(left_gs, finite_mps_from_numpy(*window, device=device),
                     right_gs)


def left_gauged_qp_from_numpy(Xs, VLs, left_gs: InfiniteMPS,
                              momentum: float,
                              right_gs: InfiniteMPS = None) -> LeftGaugedQP:
    """LeftGaugedQP from the (L, Dn, D) Xs and (L, D, d, Dn) VLs of a JAX
    QP, on the device of its ground state(s) (carried across first with
    `infinite_mps_from_numpy`): both packages then work in one null-space
    basis, which a complete QR fixes only up to a unitary."""
    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(left_gs.device)

    right = right_gs if right_gs is not None else left_gs
    return LeftGaugedQP(t(Xs), t(VLs), left_gs, right, float(momentum),
                        right_gs is None)


def finite_qp_from_numpy(Xs, VLs, ALs, ARs, mask, device="cuda") -> FiniteQP:
    """FiniteQP from the numpy Xs, VLs, full gauges and mask of a JAX
    FiniteQP, on the card unless `device` says otherwise."""
    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return FiniteQP(t(Xs), t(VLs), t(ALs), t(ARs), t(mask).to(torch.bool))


def _symmetry_data(bond_charges, phys_charges, modulus):
    return (tuple(np.array(c, dtype=np.int64, copy=True)
                  for c in bond_charges),
            tuple(int(q) for q in phys_charges),
            None if modulus is None else int(modulus))


def symmetric_finite_mps_from_numpy(ALs, ARs, AC, center: int,
                                    bond_charges, phys_charges,
                                    modulus=None,
                                    device="cuda") -> SymmetricFiniteMPS:
    """SymmetricFiniteMPS from the numpy leaves, bond charges, physical
    charges and modulus of a JAX one, on the card unless `device` says
    otherwise."""
    return SymmetricFiniteMPS(
        finite_mps_from_numpy(ALs, ARs, AC, center, device=device),
        *_symmetry_data(bond_charges, phys_charges, modulus))


def symmetric_infinite_mps_from_numpy(AL, AR, AC, C, bond_charges,
                                      phys_charges, modulus=None,
                                      device="cuda") -> SymmetricInfiniteMPS:
    """SymmetricInfiniteMPS from the numpy leaves, bond charges, physical
    charges and modulus of a JAX one, on the card unless `device` says
    otherwise."""
    return SymmetricInfiniteMPS(
        infinite_mps_from_numpy(AL, AR, AC, C, device=device),
        *_symmetry_data(bond_charges, phys_charges, modulus))


def mpo_from_numpy(W) -> MPOHamiltonian:
    """MPOHamiltonian from a (period, w, w, d, d) FSM array; reruns
    `_analyze` so the structure metadata is derived here. The FSM stays on
    the host and moves to a device on use (`stack_W`)."""
    return MPOHamiltonian._analyze(np.array(W, copy=True))


def dense_mpo_from_numpy(Os) -> DenseMPO:
    """Host DenseMPO from a sequence of (w_l, w_r, d, d) site arrays, e.g.
    `np.asarray` of a JAX DenseMPO's `Os`."""
    return DenseMPO(tuple(np.array(o, copy=True) for o in Os))


def rblocks_from_numpy(keys, blocks, device="cuda") -> RBlocks:
    """RBlocks from static keys and numpy blocks, e.g. `keys` and
    `[np.asarray(v) for v in vals]` of a JAX RBlocks, on the card unless
    `device` says otherwise."""
    return RBlocks.from_blocks(
        tuple(tuple(int(q) for q in k) for k in keys),
        [torch.from_numpy(np.array(b, copy=True)).to(device)
         for b in blocks])


def su2_reduced_state_from_numpy(AL, AR, AC, C, tjp: int,
                                 device="cuda") -> SU2ReducedState:
    """SU2ReducedState from the (keys, blocks) pairs of a JAX one's AL, AR,
    AC and C, on the card unless `device` says otherwise."""
    return SU2ReducedState(*(rblocks_from_numpy(k, b, device)
                             for k, b in (AL, AR, AC, C)), int(tjp))


def su2_finite_mps_from_numpy(sites, bonds, center: int, tjp: int,
                              device="cuda") -> SU2FiniteMPS:
    """SU2FiniteMPS from a JAX one's sites as (keys, blocks) pairs, its
    bond sector tuples, center and physical 2j."""
    return SU2FiniteMPS(
        tuple(rblocks_from_numpy(k, b, device) for k, b in sites),
        tuple(tuple((int(tj), int(m)) for tj, m in b) for b in bonds),
        int(center), int(tjp))


def su2_infinite_mps_from_numpy(AL, AR, AC, C, multiplets, tjp: int,
                                device="cuda") -> SU2InfiniteMPS:
    """SU2InfiniteMPS from the stacked (1, D, d, D) AL/AR/AC and (1, D, D)
    C of a JAX one, its bond multiplets ((2j, mult), ...) and physical
    2j."""
    return SU2InfiniteMPS(
        infinite_mps_from_numpy(AL, AR, AC, C, device=device),
        SU2Bond(tuple((int(tj), int(m)) for tj, m in multiplets)), int(tjp))


def category_from_numpy(name, sectors, qdim, N, F, dual, R=None):
    """The port's category from a JAX one's arrays (`name`, `sectors`,
    `qdim`, `N`, `F`, `dual` and, for a braided one, `R`): a
    FusionCategory for a (n,)*6 F, a MultiplicityCategory for the
    (n, n, n, n, n, m, m, n, m, m) F of arbitrary multiplicities."""
    multi = np.ndim(F) == 10
    args = (str(name), tuple(str(a) for a in sectors),
            np.array(qdim, copy=True), np.array(N, copy=True),
            np.array(F, copy=True), tuple(int(a) for a in dual))
    if R is None:
        return MultiplicityCategory(*args) if multi else FusionCategory(*args)
    cls = BraidedMultiplicityCategory if multi else BraidedCategory
    return cls(*args, np.array(R, copy=True))


def _labels(labels):
    return tuple(tuple(int(x) for x in row) for row in labels)


def anyonic_finite_mps_from_numpy(ALs, ARs, AC, center: int, cat, anyon: int,
                                  labels, schmidt_values=None,
                                  device="cuda") -> AnyonicFiniteMPS:
    """AnyonicFiniteMPS from the numpy leaves of a JAX one's state, its
    category (a port category, e.g. from `category_from_numpy`), anyon,
    per-bond labels and Schmidt values, on the card unless `device` says
    otherwise."""
    return AnyonicFiniteMPS(
        finite_mps_from_numpy(ALs, ARs, AC, center, device=device), cat,
        int(anyon), tuple(np.array(lab, dtype=np.int64, copy=True)
                          for lab in labels),
        None if schmidt_values is None else tuple(
            np.array(s, copy=True) for s in schmidt_values))


def anyonic_infinite_mps_from_numpy(AL, AR, AC, C, cat, anyon: int, labels,
                                    device="cuda") -> AnyonicInfiniteMPS:
    """AnyonicInfiniteMPS from the numpy leaves, category, anyon and (L, D)
    labels of a JAX one, on the card unless `device` says otherwise."""
    return AnyonicInfiniteMPS(
        infinite_mps_from_numpy(AL, AR, AC, C, device=device), cat,
        int(anyon), _labels(labels))


def fibonacci_infinite_mps_from_numpy(AL, AR, AC, C, labels,
                                      device="cuda") -> FibonacciInfiniteMPS:
    """FibonacciInfiniteMPS from the numpy leaves and bond labels of a JAX
    one, on the card unless `device` says otherwise."""
    return FibonacciInfiniteMPS(
        infinite_mps_from_numpy(AL, AR, AC, C, device=device),
        tuple(int(x) for x in labels))
