"""Parameter scans of VUMPS ground states (counterpart of
mpskit_tpu/algorithms/paramscan.py).

A scan is one model at several couplings: every member shares the FSM
structure (`nonzero_mask`, `diag_class`, `diag_scalar`), which is checked
when the Hamiltonians are stacked. The members iterate in lockstep until
the worst one converges, each with its own environments carried between
iterations. The JAX package vmaps one compiled iteration over the batch;
here the members run as a host loop over `_vumps_iteration_impl`, which
computes the same iterations one after the other.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..config import VERBOSE_ITER, matmul_precision
from ..environments.infinite_ham import hamiltonian_environments
from ..operators.mpo import MPOHamiltonian
from ..states.infinitemps import InfiniteMPS
from ..utils.dynamictols import updatetol
from ..utils.logging import IterLog
from ..utils.sync import to_host
from ..utils.trace import span
from .vumps import VUMPS, _vumps_iteration_impl


def stack_hamiltonians(Hs: Sequence[MPOHamiltonian]) -> MPOHamiltonian:
    """Stack same-structure Hamiltonians along a new leading batch axis:
    the result's W has shape (B, period, w, w, d, d), the structure
    metadata is the first member's."""
    H0 = Hs[0]
    for H in Hs[1:]:
        if (H.nonzero_mask != H0.nonzero_mask
                or H.diag_class != H0.diag_class
                or H.diag_scalar != H0.diag_scalar):
            raise ValueError(
                "parameter scan requires identical FSM structure across the "
                "batch (same model family; only tensor entries may differ)")
        if H.W.shape != H0.W.shape:
            raise ValueError("parameter scan requires identical FSM shapes")
    return dataclasses.replace(H0, W=np.stack([H.W for H in Hs]))


def stack_states(psis: Sequence[InfiniteMPS]) -> InfiniteMPS:
    """Stack same-shape states along a new leading batch axis."""
    return InfiniteMPS(*(torch.stack([getattr(p, f) for p in psis])
                         for f in ("AL", "AR", "AC", "C")))


def unstack_states(psis: InfiniteMPS) -> list:
    """Split a batched state back into its members."""
    return [InfiniteMPS(psis.AL[b], psis.AR[b], psis.AC[b], psis.C[b])
            for b in range(psis.AL.shape[0])]


@dataclasses.dataclass(frozen=True)
class ScanResult:
    psis: InfiniteMPS          # batched (leading axis = scan point)
    energies: torch.Tensor     # (B,) energy density per scan point
    eps: torch.Tensor          # (B,) final gauge residual per scan point
    iterations: int


def scan_groundstate_vumps(psis, Hs, alg: VUMPS = VUMPS()) -> ScanResult:
    """VUMPS over a parameter batch in lockstep.

    `psis` / `Hs` are sequences (stacked here) or already-batched ones
    with a common leading axis; the states may live on any device (the
    card unless their maker asked for the CPU). Every member iterates
    until max_b eps_b < alg.tol (a converged member's further iterations
    are fixed-point no-ops up to solver noise); then each member is
    re-canonicalized and its environments recomputed, as
    `find_groundstate_vumps` closes. `energies` and `eps` are on the
    states' device.

    Each lockstep iteration is one `scan` span (kind vumps) holding the
    members' `iteration` spans. After it, `alg.finalize` (when set) is
    called as finalize(iteration, members, Hamiltonians) with the lists of
    the members' states and Hamiltonians; a returned list of states
    replaces the members, as `find_groundstate_vumps` takes a returned
    state."""
    if not isinstance(psis, InfiniteMPS):
        psis = stack_states(list(psis))
    if not isinstance(Hs, MPOHamiltonian):
        Hs = stack_hamiltonians(list(Hs))
    B = psis.AL.shape[0]
    if Hs.W.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} states vs {Hs.W.shape[0]} "
                         "Hamiltonians")
    members = unstack_states(psis)
    Hb = [dataclasses.replace(Hs, W=Hs.W[b]) for b in range(B)]

    log = IterLog("VUMPS-scan", alg.verbosity)
    eps_max = 1.0
    env_guess = [None] * B
    eps_b = [None] * B
    it = 0
    with matmul_precision():
        for it in range(1, alg.maxiter + 1):
            inner_tol = updatetol(eps_max, it)
            with span("scan", "vumps"):
                for b in range(B):
                    members[b], eps_b[b], env_guess[b], _ = \
                        _vumps_iteration_impl(
                            members[b], Hb[b], alg.krylovdim,
                            alg.eig_maxrestarts, alg.gauge_tol, 1e-12,
                            inner_tol, env_guess=env_guess[b])
                eps_max = max(to_host(*eps_b))
            if alg.finalize is not None:
                members = list(alg.finalize(it, members, Hb) or members)
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, 0.0, eps_max)
            if eps_max < alg.tol:
                break
        else:
            log.cancel(it, 0.0, eps_max)

        # per-member exact re-canonicalization and final environments
        members = [InfiniteMPS.from_AL(p.AL, p.C[p.period - 1],
                                       tol=alg.gauge_tol) for p in members]
        energies = torch.stack([
            hamiltonian_environments(p, H, env_init=g).e_density
            for p, H, g in zip(members, Hb, env_guess)])
    return ScanResult(stack_states(members), energies, torch.stack(eps_b),
                      it)
