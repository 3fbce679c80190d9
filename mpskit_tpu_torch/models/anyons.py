"""Anyonic chain Hamiltonians of the PyTorch port (counterpart of
mpskit_tpu/models/anyons.py; host numpy FSMs), built from the general fusion-category
layer (symmetry/category.py).

Counterpart of the reference ecosystem's anyonic models (TensorKit
`Vect[FibonacciAnyon]` spaces; the hard-hexagon example
reference examples/classic2d/1.hard-hexagon/main.jl:7-8). The chains
follow Feiguin et al., PRL 98, 160409 (2007): a 1D array of anyons x whose
neighboring pairs are projected onto a fusion channel,

    H = -J Σ_i P^{(c)}_i ,

written in the fusion-path (height) basis where the MPS physical index is
the path height after each site. The admissible-path subspace is an exact
invariant of the MPO (F-symbol matrix elements vanish on inadmissible
heights), so DMRG/VUMPS/TDVP run on these like on any other spin chain.
"""

from __future__ import annotations

import numpy as np

from ..symmetry.category import (
    FusionCategory, fibonacci_category, ising_category,
)


def golden_chain(J: float = 1.0, antiferro: bool = True, period: int = 1,
                 dtype=np.float64):
    """The golden chain: Fibonacci τ-anyons with nearest-neighbor fusion
    projection (Feiguin et al. 2007). `antiferro=True` favors the vacuum
    channel (H = -J Σ P^(1), critical, c = 7/10 tricritical Ising);
    `antiferro=False` favors the τ channel (H = -J Σ P^(τ), c = 4/5,
    the 3-state-Potts / hard-hexagon universality class —
    reference examples/classic2d/1.hard-hexagon).

    Physical dimension 2 (height ∈ {1, τ})."""
    cat = fibonacci_category()
    channel = 0 if antiferro else 1
    return cat.chain_mpo(1, channel, coupling=-float(J), period=period,
                         dtype=dtype)


def ising_anyon_chain(J: float = 1.0, period: int = 1, dtype=np.float64):
    """The σ-anyon (Ising-anyon) chain H = -J Σ P^(1): exactly unitarily
    equivalent to the critical transverse-field Ising model (even heights
    carry the spins; see tests/test_category.py for the explicit map).
    Physical dimension 3 (height ∈ {1, σ, ψ})."""
    cat = ising_category()
    return cat.chain_mpo(1, 0, coupling=-float(J), period=period,
                         dtype=dtype)


def anyon_chain(cat, x: int, channel: int = 0,
                J: float = 1.0, period: int = 1, dtype=np.float64):
    """Generic anyonic chain H = -J Σ P^{(channel)} for any unitary
    fusion category: a multiplicity-free `FusionCategory` (physical
    dimension n, height basis) or a `MultiplicityCategory` with
    N[a,b,c] > 1 (physical dimension n·m over the (height, vertex-
    multiplicity) basis — e.g. Rep(A4)); both expose the same
    `chain_mpo` constructor."""
    return cat.chain_mpo(x, channel, coupling=-float(J), period=period,
                         dtype=dtype)


def rsos_chain(k: int, J: float = 1.0, antiferro: bool = True,
               period: int = 1, dtype=np.float64):
    """su(2)_k spin-½ anyon chain (the quantum A_{k+1} RSOS chain):
    heights walk the A_{k+1} Dynkin diagram, H = -J Σ P^{(channel)} with
    the vacuum channel for `antiferro`. Critical points: AFM is the
    unitary minimal model M(k+1, k+2), c = 1 - 6/((k+1)(k+2)); FM is the
    Z_k parafermion CFT, c = 2(k-1)/(k+2) (Gils et al., PRB 87, 235120).
    k=2 reproduces the Ising-anyon chain (critical TFIM), k=3 the golden
    chain's spectra on the vacuum-anchored path sector.

    Physical dimension k+1 (height a = 2j ∈ {0..k})."""
    from ..symmetry.category import su2k_category

    cat = su2k_category(k)
    return cat.chain_mpo(1, 0 if antiferro else 2, coupling=-float(J),
                         period=period, dtype=dtype)


def _reachable(cat: FusionCategory, start: int, x: int, steps: int):
    """Sectors reachable from `start` by `steps` fusions with x."""
    cur = {start}
    adm = cat.N[:, x, :] > 0
    for _ in range(steps):
        cur = {int(b) for a in cur for b in np.where(adm[a])[0]}
    return cur


def anyon_chain_finite(cat: FusionCategory, x: int, L: int,
                       channel: int = 0, J: float = 1.0,
                       pin_left: int | None = None,
                       pin_right: int | None = None,
                       lam: float = 4.0, dtype=np.float64):
    """Finite anyonic chain with **pinned boundary heights** — the
    tensor-basis counterpart of fixing the fusion-tree boundary sectors
    (what the reference gets for free from anyonic `TensorMap` index
    sectors). Over the unconstrained height basis the open chain's ground
    state is exactly degenerate across boundary-height sectors (the
    topological Verlinde-line symmetry), so DMRG lands in arbitrary
    superpositions; pinning h_1 and h_L restores a unique ground state
    with the clean Calabrese-Cardy entanglement arch.

    Pins default to h_1 = x (the unique sector in vacuum ⊗ x) and, on the
    right, the lowest-quantum-dimension sector reachable in L-1 steps
    (vacuum when parity allows — e.g. the σ-chain alternates {1,ψ}/σ).
    Implemented as single-site penalties λ(1 - |pin><pin|) at the edges of
    a period-L MPO; λ > spectral width keeps the pinned sector lowest.

    Returns ``(H, (pin_left, pin_right))``.
    """
    from ..operators.mpo import MPOHamiltonian

    if pin_left is None:
        (pin_left,) = cat.fuse(0, x)
    if pin_right is None:
        reach = _reachable(cat, pin_left, x, L - 1)
        pin_right = min(reach, key=lambda a: (cat.qdim[a], a))
    H = cat.chain_mpo(x, channel, coupling=-float(J), period=L, dtype=dtype)
    n = cat.n

    def pen(h):
        P = np.eye(n, dtype=dtype)
        P[h, h] = 0.0
        return float(lam) * P

    entries = {(0, 0, 1): pen(pin_left), (L - 1, 0, 1): pen(pin_right)}
    for i in range(L):
        entries[(i, 0, 0)] = 1.0
        entries[(i, 1, 1)] = 1.0
    Hpin = MPOHamiltonian.from_fsm(entries, 2, n, period=L, dtype=dtype)
    return H + Hpin, (int(pin_left), int(pin_right))
