"""MPO-times-MPS application (counterpart of mpskit_tpu/operators/apply.py).

Finite: exact fused-bond application (D -> w*D) followed by an SVD
compression back to the target bond dimension. Infinite: fused application
and re-gauging. The DenseMPO's host tensors move to the state's device
here, in the promoted dtype of the two (as the JAX package promotes).
"""

from __future__ import annotations

import torch

from .mpo import DenseMPO
from ..states.finitemps import FiniteMPS
from ..states.infinitemps import InfiniteMPS
from ..tensors.ops import TruncationScheme, truncdim


def _site_tensor(O: DenseMPO, i: int, like):
    """O's site i on like's device, in the dtype promoted with like's."""
    Oi = torch.from_numpy(O.site(i))
    return Oi.to(device=like.device,
                 dtype=torch.promote_types(Oi.dtype, like.dtype))


def apply_densempo_finite(O: DenseMPO, psi: FiniteMPS, Dmax: int = None,
                          trscheme: TruncationScheme = None,
                          left_vec=None, right_vec=None) -> FiniteMPS:
    """O |psi> as a FiniteMPS with bond dimension Dmax (default: psi.D).

    For evolution MPOs built from FSM Hamiltonians the boundary vectors
    default to level 0 on both ends; ragged MPOs (size-1 edge virtual
    legs) are contracted with trivial boundary vectors."""
    from ..algorithms.changebonds import SvdCut, _svdcut_finite

    L, D, d = psi.length, psi.D, psi.physicaldim
    psi0 = psi.move_center(0)
    As = [psi0.AC] + [psi0.ARs[i] for i in range(1, L)]

    fused = []
    for i in range(L):
        Oi = _site_tensor(O, i, psi.AC)
        wl, wr = Oi.shape[0], Oi.shape[1]
        T = torch.einsum("abst,ltr->alsbr", Oi, As[i].to(Oi.dtype))
        if i == 0:
            lv = left_vec
            if lv is None:
                lv = torch.zeros((wl,), dtype=Oi.dtype, device=Oi.device)
                lv[0] = 1.0
            T = torch.einsum("a,alsbr->lsbr", lv.to(Oi.dtype), T).reshape(
                D, d, wr * D)
        else:
            T = T.reshape(wl * D, d, wr * D)
        if i == L - 1:
            rv = right_vec
            if rv is None:
                rv = torch.zeros((wr,), dtype=Oi.dtype, device=Oi.device)
                rv[0] = 1.0
            T = torch.einsum("lsbr,b->lsr",
                             T.reshape(T.shape[0], d, wr, D), rv.to(Oi.dtype))
        fused.append(T)

    D_new = max(max(t.shape[0] for t in fused),
                max(t.shape[-1] for t in fused))
    stacked = torch.zeros((L, D_new, d, D_new), dtype=fused[0].dtype,
                          device=psi.device)
    for i, T in enumerate(fused):
        stacked[i, : T.shape[0], :, : T.shape[-1]] = T
    big = FiniteMPS.from_tensors(stacked, normalize=True)

    Dt = Dmax or D
    big = _svdcut_finite(big, SvdCut(trscheme or truncdim(Dt)))
    return _restrict_bond(big, Dt)


def _restrict_bond(psi: FiniteMPS, D_new: int) -> FiniteMPS:
    """Slice a (truncated, masked) FiniteMPS down to a smaller static D.
    Only valid when the Schmidt ranks have been cut to <= D_new."""
    if D_new == psi.D:
        return psi
    psi0 = psi.move_center(0)
    return FiniteMPS(psi0.ALs[:, :D_new, :, :D_new].contiguous(),
                     psi0.ARs[:, :D_new, :, :D_new].contiguous(),
                     psi0.AC[:D_new, :, :D_new].contiguous(), 0)


def apply_densempo_infinite(O: DenseMPO, psi: InfiniteMPS) -> InfiniteMPS:
    """Fused-bond application for uniform states: the bond grows to w*D and
    is re-gauged; compress afterwards with changebonds."""
    L, D, d = psi.period, psi.D, psi.physicaldim
    A_new = []
    for i in range(L):
        Oi = _site_tensor(O, i, psi.AL)
        w = Oi.shape[0]
        A_new.append(torch.einsum("abst,ltr->alsbr", Oi,
                                  psi.AL[i].to(Oi.dtype)).reshape(
            w * D, d, w * D))
    return InfiniteMPS.from_A(torch.stack(A_new))
