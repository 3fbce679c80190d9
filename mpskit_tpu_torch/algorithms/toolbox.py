"""The part of mpskit_tpu/algorithms/toolbox.py that the two-site and bond
slice uses: `entanglement_spectrum` and `entropy` of finite and infinite
states. The rest of the toolbox comes with queue-1 item 10 (ROADMAP.md)."""

from __future__ import annotations

import torch

from ..states.finitemps import FiniteMPS
from ..states.infinitemps import InfiniteMPS
from ..tensors.ops import safe_xlogx


def _normalized_svdvals(C):
    S = torch.linalg.svdvals(C)
    return S / torch.clamp(torch.linalg.vector_norm(S), min=1e-30)


def entanglement_spectrum(psi, bond: int = None):
    """Normalized Schmidt values across `bond`: for a FiniteMPS the bond
    right of site bond-1 (default the middle one), for an InfiniteMPS the
    singular values of C[bond] (default 0)."""
    if isinstance(psi, FiniteMPS):
        if bond is None:
            bond = psi.length // 2
        if bond == 0:
            return torch.ones((1,), dtype=torch.float64, device=psi.device)
        return _normalized_svdvals(psi.move_center(bond - 1).bond_matrix())
    if isinstance(psi, InfiniteMPS):
        return _normalized_svdvals(psi.C[(bond or 0) % psi.period])
    raise NotImplementedError(
        f"entanglement_spectrum of a {type(psi).__name__} is not ported yet: "
        "windows come with queue-1 item 10 (ROADMAP.md)")


def entropy(psi, bond: int = None):
    """Von Neumann entanglement entropy at a bond (0-dim tensor)."""
    S = entanglement_spectrum(psi, bond)
    return -torch.sum(safe_xlogx(S ** 2))
