"""Generic anyonic infinite MPS over the fusion-path basis of any
multiplicity-free unitary fusion category (counterpart of
mpskit_tpu/symmetry/anyonic.py): the dense InfiniteMPS plus static
PER-BOND sector labels (`category.chain_bond_labels`), needed where the
chain anyon's fusion graph is k-partite (the Ising sigma chain's heights
alternate {1, psi} / {sigma}) and no uniform split exists. The per-site
masks ride the masking hooks of the VUMPS iteration
(`algorithms/vumps._vumps_iteration_impl`).

Scope, as in the JAX package: where the fusion graph forces the sector
structure (the sigma chain) the masked class is exact; for uniform-sector
critical chains (the golden chain) a masked bond of dimension D is
strictly weaker than a dense one, because the flat height basis's Schmidt
vectors mix sectors. There is no masked one-site finite DMRG: a one-site
update acts only on the physical height, not on its double, the bond
sector, so a masked finite sweep freezes. Two-site updates re-create the
middle bond and do not freeze: `symmetry/anyonic_finite.py` has the
sector-resolved DMRG2 and IDMRG2.

Entanglement readouts take the quantum trace per bond
(`category.quantum_schmidt` / `quantum_entropy`) on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .category import (
    FusionCategory, chain_bond_labels, chain_masks, quantum_entropy,
    quantum_schmidt,
)
from .fibonacci import _generator, _host, _randn, masked_state


@dataclasses.dataclass(frozen=True)
class AnyonicInfiniteMPS:
    """Uniform MPS over the height basis of a chain of anyons `anyon` in
    category `cat`: the dense state and static per-bond sector labels
    (labels[i] labels the bond right of site i)."""

    state: object                        # InfiniteMPS
    cat: FusionCategory
    anyon: int
    labels: Tuple[Tuple[int, ...], ...]  # (L, D)

    @property
    def masks(self):
        return chain_masks(self.cat, self.anyon,
                           np.asarray(self.labels, int), self.state.period)

    @staticmethod
    def random(cat: FusionCategory, anyon: int, D: int, L: int,
               seed: Tuple[int, ...] | None = None, dtype=torch.float64,
               device="cuda", generator: torch.Generator = None
               ) -> "AnyonicInfiniteMPS":
        """Random masked start, on the card unless `device` says otherwise.
        `seed` pins bond 0's allowed sector set (`chain_bond_labels`); the
        default is the stationary support, which for k-partite fusion
        graphs mixes the sublattice classes (`seed=(1,)` starts the Ising
        sigma chain on a sigma bond). `generator` lives on `device` (None:
        seeded 0)."""
        labels = chain_bond_labels(cat, anyon, D, L, seed=seed)
        A_mask, C_mask = chain_masks(cat, anyon, labels, L)
        A = _randn((L, D, cat.n, D), dtype, device,
                   _generator(generator, device))
        A = A * torch.as_tensor(A_mask, device=device).to(dtype)
        return AnyonicInfiniteMPS(masked_state(A, A_mask, C_mask), cat,
                                  int(anyon),
                                  tuple(tuple(int(x) for x in row)
                                        for row in labels))

    def schmidt(self, bond: int = 0):
        """{sector: probabilities} of bond `bond` under the quantum
        trace."""
        b = bond % self.state.period
        return quantum_schmidt(self.cat, np.asarray(self.labels[b]),
                               _host(self.state.C[b]))

    def entropy(self, bond: int = 0) -> float:
        """Quantum-trace entanglement entropy of bond `bond`."""
        b = bond % self.state.period
        return quantum_entropy(self.cat, np.asarray(self.labels[b]),
                               _host(self.state.C[b]))


def find_groundstate_anyonic(spsi: AnyonicInfiniteMPS, H, alg=None):
    """Sector-masked VUMPS on a height-basis chain MPO (e.g.
    `models.anyon_chain(cat, x)`): the per-bond masks are re-applied at
    every gauge step, so the state stays in the fusion-path sector; a
    final re-canonicalization `from_AL` and a re-mask. Returns
    (AnyonicInfiniteMPS, envs, eps)."""
    from ..algorithms.vumps import VUMPS, _vumps_iteration_impl
    from ..config import VERBOSE_ITER, matmul_precision
    from ..environments.infinite_ham import hamiltonian_environments
    from ..states.infinitemps import InfiniteMPS
    from ..utils.dynamictols import updatetol
    from ..utils.logging import IterLog
    from ..utils.sync import to_host

    if alg is None:
        alg = VUMPS()
    psi = spsi.state
    A_mask, C_mask = (torch.as_tensor(m, device=psi.device)
                      for m in spsi.masks)
    log = IterLog("VUMPS(anyonic)", alg.verbosity)
    eps = 1.0
    env_guess = None
    with matmul_precision():
        for it in range(1, alg.maxiter + 1):
            inner_tol = updatetol(eps, it)
            psi, eps_dev, env_guess, diag = _vumps_iteration_impl(
                psi, H, alg.krylovdim, alg.eig_maxrestarts, alg.gauge_tol,
                1e-12, inner_tol, A_mask=A_mask, C_mask=C_mask,
                env_guess=env_guess)
            eps = to_host(eps_dev)[0]
            log.solver_warn(it, diag, inner_tol)
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, 0.0, eps)
            if eps < alg.tol:
                break
        else:
            log.cancel(alg.maxiter, 0.0, eps)
        psi = InfiniteMPS.from_AL(psi.AL, psi.C[psi.period - 1],
                                  tol=alg.gauge_tol)
        Am, Cm = A_mask.to(psi.dtype), C_mask.to(psi.dtype)
        psi = InfiniteMPS(psi.AL * Am, psi.AR * Am, psi.AC * Am, psi.C * Cm)
        envs = hamiltonian_environments(psi, H, env_init=env_guess)
    return dataclasses.replace(spsi, state=psi), envs, eps
