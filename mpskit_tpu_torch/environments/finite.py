"""Finite-chain environments (counterpart of
mpskit_tpu/environments/finite.py): the JAX scans become host loops that
fill preallocated (L+1, w, D, D) stacks."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..transfermatrix.transfer import transfer_left_mpo, transfer_right_mpo


def left_boundary(w: int, D: int, dtype, device="cpu"):
    """(w, D, D) boundary left environment: FSM level 0, rank 1 in the
    (padded) size-1 boundary bond."""
    GL = torch.zeros((w, D, D), dtype=dtype, device=device)
    GL[0, 0, 0] = 1.0
    return GL


def right_boundary(w: int, D: int, dtype, device="cpu"):
    GR = torch.zeros((w, D, D), dtype=dtype, device=device)
    GR[w - 1, 0, 0] = 1.0
    return GR


def compute_left_envs(As, Ws, GL0):
    """GLs[i] = environment left of site i; L+1 entries.
    As (L, D, d, D) gauged tensors, Ws (L, w, w, d, d)."""
    L = As.shape[0]
    GLs = torch.empty((L + 1,) + tuple(GL0.shape), dtype=GL0.dtype,
                      device=GL0.device)
    GLs[0] = GL0
    for i in range(L):
        GLs[i + 1] = transfer_left_mpo(GLs[i], Ws[i], As[i], As[i])
    return GLs


def compute_right_envs(As, Ws, GRL):
    """GRs[i] = environment right of site i-1; GRs[L] = boundary, GRs[i]
    built from sites i..L-1."""
    L = As.shape[0]
    GRs = torch.empty((L + 1,) + tuple(GRL.shape), dtype=GRL.dtype,
                      device=GRL.device)
    GRs[L] = GRL
    for i in range(L - 1, -1, -1):
        GRs[i] = transfer_right_mpo(GRs[i + 1], Ws[i], As[i], As[i])
    return GRs


@dataclasses.dataclass(frozen=True)
class FiniteEnv:
    """GLs[i] = left env of site i (GLs[0] = boundary); GRs[i] = right env
    of site i-1 (GRs[L] = boundary); site i uses (GLs[i], GRs[i+1])."""

    GLs: torch.Tensor  # (L+1, w, D, D)
    GRs: torch.Tensor  # (L+1, w, D, D)

    def leftenv(self, i):
        return self.GLs[i]

    def rightenv(self, i):
        return self.GRs[i + 1]


def stack_W(H, L: int, dtype=None, device="cpu"):
    """The (period, w, w, d, d) host FSM array of an MPOHamiltonian tiled to
    length L and moved to `device` as an (L, w, w, d, d) tensor of `dtype`
    (a real dtype keeps the real part, as `astype` does in the JAX
    package)."""
    W = H.W
    reps = -(-L // W.shape[0])
    W = np.tile(W, (reps, 1, 1, 1, 1))[:L]
    out = torch.from_numpy(np.ascontiguousarray(W))
    if dtype is not None:
        if not dtype.is_complex and out.is_complex():
            out = out.real
        out = out.to(dtype)
    return out.to(device)


def finite_environments(psi, H) -> FiniteEnv:
    """Environments of <psi| H |psi> for a FiniteMPS in mixed gauge."""
    L, D = psi.length, psi.D
    Ws = stack_W(H, L, psi.dtype, psi.device)
    w = Ws.shape[1]
    GLs = compute_left_envs(psi.ALs, Ws,
                            left_boundary(w, D, psi.dtype, psi.device))
    GRs = compute_right_envs(psi.ARs, Ws,
                             right_boundary(w, D, psi.dtype, psi.device))
    return FiniteEnv(GLs, GRs)
