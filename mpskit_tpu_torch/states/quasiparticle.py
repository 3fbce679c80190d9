"""The part of mpskit_tpu/states/quasiparticle.py that bond management
needs: `full_gauges`. The quasiparticle states come with the excitations
(ROADMAP.md, queue 1, item 8)."""

from __future__ import annotations

from ..tensors.ops import leftorth, rightorth
from .finitemps import FiniteMPS


def full_gauges(psi: FiniteMPS):
    """(ALs, ARs) with every site's left- and right-gauged tensor valid."""
    L = psi.length
    pl = psi.move_center(L - 1)
    ALs = pl.ALs.clone()
    ALs[L - 1], _ = leftorth(pl.AC)
    pr = psi.move_center(0)
    ARs = pr.ARs.clone()
    _, ARs[0] = rightorth(pr.AC)
    return ALs, ARs
