"""Bond-dimension management (counterpart of
mpskit_tpu/algorithms/changebonds.py) for FiniteMPS, InfiniteMPS,
MPSMultiline, and for a DenseMPO or MPOMultiline through the InfiniteMPS
of their site tensors.

Under the static-shape design, cutting is masking (Schmidt values zeroed
in place, shapes unchanged) and expanding is a re-padding of the stacked
tensors to a larger static D, with the new directions seeded randomly
(`RandExpand`) or from the two-site derivative projected on the tangent
null spaces (`OptimalExpand`). The JAX package's `PRNGKey(42)` noise is a
`torch.Generator` seeded 42 on the state's device: the same distribution,
other numbers.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import matmul_precision
from ..environments.finite import (
    compute_left_envs, compute_right_envs, left_boundary, right_boundary,
    stack_W,
)
from ..environments.infinite_ham import hamiltonian_environments
from ..environments.infinite_mpo import mpo_environments, stack_O
from ..operators.mpo import DenseMPO, mpo_to_mps, mps_to_mpo
from ..operators.multiline import MPOMultiline
from ..states.finitemps import FiniteMPS, support_mask
from ..states.infinitemps import InfiniteMPS
from ..states.multiline import MPSMultiline
from ..states.quasiparticle import full_gauges
from ..tensors.ops import (
    TruncationScheme, leftnull, notrunc, rightnull, rightorth, svd_truncated,
)
from ..utils.sync import to_host
from .derivatives import ac2_apply
from .unionalg import Chainable, ChainedAlg



@dataclasses.dataclass(frozen=True)
class SvdCut(Chainable):
    trscheme: TruncationScheme = dataclasses.field(default_factory=notrunc)


@dataclasses.dataclass(frozen=True)
class RandExpand(Chainable):
    """Expand every bond by `dims` extra directions (random seeds)."""

    dims: int = 8


@dataclasses.dataclass(frozen=True)
class OptimalExpand(Chainable):
    """Expand every bond by `dims` directions chosen from the dominant
    singular vectors of the projected two-site derivative."""

    dims: int = 8


@dataclasses.dataclass(frozen=True)
class VUMPSSvdCut(Chainable):
    trscheme: TruncationScheme = dataclasses.field(default_factory=notrunc)


def _svdcut_finite(psi: FiniteMPS, alg: SvdCut) -> FiniteMPS:
    """Sweep right to left, truncating every bond (masked, static
    shapes)."""
    L, D = psi.length, psi.D
    psi = psi.move_center(L - 1)
    AC, ALs = psi.AC, psi.ALs
    ARs = psi.ARs.clone()
    for i in range(L - 1, 0, -1):
        C, AR = rightorth(AC)
        U, S, Vh, _ = svd_truncated(C, D, alg.trscheme)
        S = S / torch.clamp(torch.linalg.vector_norm(S), min=1e-30)
        ARs[i] = torch.einsum("km,mpr->kpr", Vh, AR)
        AC = torch.einsum("lpm,mk->lpk", ALs[i - 1], U * S.to(U.dtype))
    return FiniteMPS(ALs, ARs, AC, 0).normalize()


def _svdcut_infinite(psi: InfiniteMPS, alg: SvdCut) -> InfiniteMPS:
    """Rotate each bond into its Schmidt basis with the discarded
    directions masked, and gauge-fix the rotated cell."""
    L, D = psi.period, psi.D
    Us = [svd_truncated(psi.C[i], D, alg.trscheme)[0] for i in range(L)]
    A = torch.stack([torch.einsum("ml,mpr,rk->lpk", Us[i - 1].conj(),
                                  psi.AL[i], Us[i]) for i in range(L)])
    return InfiniteMPS.from_A(A)


def changebonds(psi, *args, device="cuda"):
    """changebonds(psi, alg) or changebonds(psi, H, alg[, envs]).

    A trailing `envs` is accepted for signature parity and has no effect:
    the expanders recompute the environments they need from the state. A
    DenseMPO (or each row of an MPOMultiline) is managed as the InfiniteMPS
    of its site tensors, made on `device` (the card unless the caller asks
    for the CPU), and comes back as a host DenseMPO."""
    if len(args) == 1:
        H, alg = None, args[0]
    else:
        H, alg = args[0], args[1]

    if isinstance(alg, ChainedAlg):
        # apply each stage in sequence (e.g. OptimalExpand() & SvdCut())
        for stage in alg:
            psi = changebonds(psi, *((stage,) if H is None else (H, stage)),
                              device=device)
        return psi

    if isinstance(psi, MPSMultiline):
        return _changebonds_multiline(psi, H, alg)
    if isinstance(psi, MPOMultiline):
        return MPOMultiline(tuple(
            changebonds(r, *((alg,) if H is None else (H, alg)),
                        device=device) for r in psi.rows))
    if isinstance(psi, DenseMPO):
        d = psi.site(0).shape[2]
        return mps_to_mpo(changebonds(mpo_to_mps(psi, device), alg), d)
    if not isinstance(psi, (FiniteMPS, InfiniteMPS)):
        raise NotImplementedError(
            f"changebonds on a {type(psi).__name__} is not ported yet: "
            "SU(2)-reduced chains come with queue-1 item 11 (ROADMAP.md)")

    if isinstance(alg, SvdCut):
        if isinstance(psi, FiniteMPS):
            return _svdcut_finite(psi, alg)
        return _svdcut_infinite(psi, alg)
    if isinstance(alg, RandExpand):
        return _expand(psi, alg.dims)
    if isinstance(alg, OptimalExpand):
        if H is None:
            raise ValueError("OptimalExpand needs the Hamiltonian")
        return _expand(psi, alg.dims, H=H)
    if isinstance(alg, VUMPSSvdCut):
        if not isinstance(psi, InfiniteMPS) or H is None:
            raise ValueError(
                "VUMPSSvdCut needs an InfiniteMPS and the Hamiltonian")
        return _vumpssvd_cut(psi, H, alg)
    raise TypeError(type(alg))


def _changebonds_multiline(psi: MPSMultiline, O, alg) -> MPSMultiline:
    """SvdCut and RandExpand row by row; OptimalExpand grows row r+1 along
    the row-r two-site derivative in the mixed (ket row r, bra row r+1)
    environments of O's row r."""
    R = psi.nrows
    if isinstance(alg, (SvdCut, RandExpand)):
        return MPSMultiline(tuple(changebonds(r, alg) for r in psi.rows))
    if isinstance(alg, OptimalExpand):
        if O is None:
            raise ValueError("OptimalExpand needs the transfer MPO")
        if not isinstance(O, MPOMultiline):
            O = MPOMultiline.from_mpo(O, R)
        if O.nrows not in (1, R):
            raise ValueError(f"an MPOMultiline of {O.nrows} rows on {R}")
        rows = list(psi.rows)
        for r in range(R):
            rows[(r + 1) % R] = _expand_multiline_row(
                psi.rows[r], O.row(r), psi.rows[(r + 1) % R], alg.dims)
        return MPSMultiline(tuple(rows))
    raise TypeError(type(alg))


def _expand_multiline_row(below: InfiniteMPS, O, above: InfiniteMPS,
                          extra: int) -> InfiniteMPS:
    """`above` (row r+1) grown by `extra` directions: the dominant left
    singular vectors of the row-r two-site derivative projected on row
    r+1's tangent null spaces, with a small random block among the new
    directions."""
    L, D, d = above.period, above.D, above.physicaldim
    dtype, device = above.dtype, above.device
    with matmul_precision():
        Os = stack_O(O, L, below.dtype, device)
        envs = mpo_environments(below, Os, psi_bra=above)
        A = _pad_bond(above.AL, D + extra, (1, 3))
        for i in range(L):
            j = (i + 1) % L
            theta = torch.einsum("lpm,mqr->lpqr", below.AC[i], below.AR[j])
            h2 = ac2_apply(envs.GLs[i], Os[i], Os[j], envs.GRs[j], theta)
            VL = leftnull(above.AL[i])
            VR = rightnull(above.AR[j])
            M = torch.einsum("lpk,lpqr,mqr->km", VL.conj(), h2, VR.conj())
            U = svd_truncated(M, min(extra, M.shape[0]), notrunc())[0]
            A[i, :D, :, D:D + U.shape[1]] = torch.einsum("lpk,ke->lpe", VL,
                                                         U)
        mask = torch.zeros(A.shape, dtype=torch.bool, device=device)
        mask[:, D:, :, D:] = True
        return InfiniteMPS.from_A(A + _noise(A.shape, 1e-6, dtype, device)
                                  * mask)


def _vumpssvd_cut(psi: InfiniteMPS, H, alg: VUMPSSvdCut) -> InfiniteMPS:
    """Two-site eigensolve and truncated-SVD re-split of every bond, as a
    short IDMRG2 refinement under the scheme until the Schmidt spectra
    settle (at most 30 iterations). A one-site cell is doubled."""
    from .idmrg import _idmrg2_iteration

    if psi.period == 1:
        psi = psi.repeat(2)
    L = psi.period
    with matmul_precision():
        envs = hamiltonian_environments(psi, H)
        Ws = stack_W(H, L, psi.dtype, psi.device)
        Ss = torch.linalg.svdvals(psi.C)
        ALs, ARs, AC0, GLs, GRs = psi.AL, psi.AR, psi.AC[0], envs.GLs, \
            envs.GRs
        for _ in range(30):
            ALs, ARs, AC0, Ss, GLs, GRs, _, dC, _, _ = _idmrg2_iteration(
                ALs, ARs, AC0, Ss, GLs, GRs, 30, 2, alg.trscheme, Ws=Ws,
                inner_tol=1e-9)
            if to_host(dC)[0] < 1e-8:
                break
        return InfiniteMPS.from_A(ARs)


def _pad_bond(arr, D_new: int, axes):
    """Zero-pad the virtual axes `axes` of arr to D_new."""
    shape = list(arr.shape)
    for ax in axes:
        shape[ax] = D_new
    out = torch.zeros(shape, dtype=arr.dtype, device=arr.device)
    out[tuple(slice(0, n) for n in arr.shape)] = arr
    return out


def _expand_finite_optimal(psi: FiniteMPS, extra: int, H) -> FiniteMPS:
    """Derivative-seeded finite expansion: at every bond the two-site
    derivative is projected on the left and right tangent null spaces; its
    dominant right singular vectors seed new AR rows, while AL and AC get
    zero columns, so the state is unchanged."""
    L, D, d = psi.length, psi.D, psi.physicaldim
    D_new = D + extra
    dtype, device = psi.dtype, psi.device
    with matmul_precision():
        Ws = stack_W(H, L, dtype, device)
        w = Ws.shape[1]
        ALs_f, ARs_f = full_gauges(psi)
        GLs = compute_left_envs(ALs_f, Ws, left_boundary(w, D, dtype, device))
        GRs = compute_right_envs(ARs_f, Ws,
                                 right_boundary(w, D, dtype, device))

        p = psi.move_center(0)
        ALs_new = _pad_bond(p.ALs, D_new, (1, 3))
        ARs_new = _pad_bond(p.ARs, D_new, (1, 3))
        AC_new = _pad_bond(p.AC, D_new, (0, 2))
        for i in range(L - 1):
            p = p.move_center(i)
            theta = torch.einsum("lpm,mqr->lpqr", p.AC, ARs_f[i + 1])
            h2 = ac2_apply(GLs[i], Ws[i], Ws[i + 1], GRs[i + 2], theta)
            NL = leftnull(p.AC)                 # (D, d, Dd - D)
            NR = rightnull(ARs_f[i + 1])        # (Dd - D, d, D)
            M = torch.einsum("lpk,lpqr,mqr->km", NL.conj(), h2, NR.conj())
            # dominant right singular vectors -> new AR rows
            Vh = torch.linalg.svd(M, full_matrices=False)[2]
            e = min(extra, Vh.shape[0])
            ARs_new[i + 1, D:D + e, :, :D] = torch.einsum(
                "em,mqr->eqr", Vh[:e], NR)

    mask = torch.as_tensor(support_mask(L, d, D_new), device=device)
    return FiniteMPS(ALs_new * mask, ARs_new * mask, AC_new * mask[0], 0)


def _noise(shape, scale: float, dtype, device):
    """Real Gaussian noise of `scale` from a generator seeded 42 on
    `device`, cast to dtype."""
    gen = torch.Generator(device=device).manual_seed(42)
    rdtype = torch.empty((), dtype=dtype).real.dtype
    return (scale * torch.randn(shape, generator=gen, dtype=rdtype,
                                device=device)).to(dtype)


def _expand(psi, extra: int, H=None):
    """A new state with every virtual bond enlarged by `extra`. With H
    (OptimalExpand) the new AL directions of an infinite state come from
    the SVD of the null-space-projected two-site derivative; without it
    (RandExpand) they are random.

    A finite state without H is re-padded only: the padded static-D layout
    already exposes the full supported block of D_new to the masked local
    eigensolves, so DMRG explores the new directions on the next sweep
    however they are seeded."""
    if isinstance(psi, FiniteMPS):
        if H is not None:
            return _expand_finite_optimal(psi, extra, H)
        D_new = psi.D + extra
        p = psi.move_center(0)
        return FiniteMPS(_pad_bond(p.ALs, D_new, (1, 3)),
                         _pad_bond(p.ARs, D_new, (1, 3)),
                         _pad_bond(p.AC, D_new, (0, 2)), 0)

    L, D, d = psi.period, psi.D, psi.physicaldim
    D_new = D + extra
    dtype, device = psi.dtype, psi.device
    if H is None:
        A = _pad_bond(psi.AL, D_new, (1, 3))
        mask = torch.zeros(A.shape, dtype=torch.bool, device=device)
        mask[:, D:] = True
        mask[:, :, :, D:] = True
        return InfiniteMPS.from_A(A + _noise(A.shape, 1e-5, dtype, device)
                                  * mask)

    with matmul_precision():
        envs = hamiltonian_environments(psi, H)
        Ws = stack_W(H, L, dtype, device)
        A = _pad_bond(psi.AL, D_new, (1, 3))
        for i in range(L):
            j = (i + 1) % L
            theta = torch.einsum("lpm,mqr->lpqr", psi.AC[i], psi.AR[j])
            h2 = ac2_apply(envs.GLs[i], Ws[i], Ws[j], envs.GRs[j], theta)
            # project out the current tangent directions
            VL = leftnull(psi.AL[i])          # (D, d, D(d-1))
            VR = rightnull(psi.AR[j])         # (D(d-1), d, D)
            M = torch.einsum("lpk,lpqr,mqr->km", VL.conj(), h2, VR.conj())
            U = svd_truncated(M, min(extra, M.shape[0]), notrunc())[0]
            # new left directions VL @ U (D, d, extra)
            A[i, :D, :, D:D + U.shape[1]] = torch.einsum("lpk,ke->lpe", VL,
                                                         U)
        # a small random block among the new directions keeps full rank
        mask = torch.zeros(A.shape, dtype=torch.bool, device=device)
        mask[:, D:, :, D:] = True
        return InfiniteMPS.from_A(A + _noise(A.shape, 1e-6, dtype, device)
                                  * mask)
