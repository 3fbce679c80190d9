"""Carry state over from numpy arrays, e.g. `np.asarray` of the leaves of
a state or MPO made by the JAX package, so that both packages compute from
the same numbers (their random generators differ)."""

from __future__ import annotations

import numpy as np
import torch

from .operators.mpo import MPOHamiltonian
from .states.finitemps import FiniteMPS


def finite_mps_from_numpy(ALs, ARs, AC, center: int,
                          device="cpu") -> FiniteMPS:
    """FiniteMPS from stacked (L, D, d, D) ALs/ARs and a (D, d, D) AC."""
    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return FiniteMPS(t(ALs), t(ARs), t(AC), int(center))


def mpo_from_numpy(W) -> MPOHamiltonian:
    """MPOHamiltonian from a (period, w, w, d, d) FSM array; reruns
    `_analyze` so the structure metadata is derived here. The FSM stays on
    the host and moves to a device on use (`stack_W`)."""
    return MPOHamiltonian._analyze(np.array(W, copy=True))
