"""Window MPS (counterpart of mpskit_tpu/states/windowmps.py): a finite,
mutable window embedded in an infinite background. The window's boundary
environments are the fixed points of the infinite sides, so local physics
inside the window sees the infinite system.

The window keeps the padded static-D layout of FiniteMPS: its bond
dimension is at least the infinite states', whose tensors sit in the
leading block of every padded one."""

from __future__ import annotations

import dataclasses

import torch

from .finitemps import FiniteMPS
from .infinitemps import InfiniteMPS


def _infinite_on(psi: InfiniteMPS, device) -> InfiniteMPS:
    """psi itself when it lies on `device`, else a copy there."""
    ts = (psi.AL, psi.AR, psi.AC, psi.C)
    moved = tuple(t.to(device) for t in ts)
    return psi if all(a is b for a, b in zip(ts, moved)) else \
        InfiniteMPS(*moved)


def _padded_cells(As, n: int, Dw: int, dtype):
    """n consecutive cells of the (p, D, d, D) stack As (site i takes
    As[i % p]) in the leading block of zero (n, Dw, d, Dw) tensors."""
    p, D, d = As.shape[0], As.shape[1], As.shape[2]
    out = torch.zeros((n, Dw, d, Dw), dtype=dtype, device=As.device)
    idx = torch.arange(n, device=As.device) % p
    out[:, :D, :, :D] = As[idx].to(dtype)
    return out


@dataclasses.dataclass(frozen=True)
class WindowMPS:
    left_gs: InfiniteMPS
    window: FiniteMPS
    right_gs: InfiniteMPS

    @property
    def length(self) -> int:
        return self.window.length

    def __len__(self):
        return self.length

    @property
    def D(self) -> int:
        return self.window.D

    @property
    def dtype(self):
        return self.window.dtype

    @property
    def device(self):
        return self.window.device

    @staticmethod
    def from_infinite(psi: InfiniteMPS, L: int, D: int = None,
                      device="cuda") -> "WindowMPS":
        """A length-L window cut out of an infinite state, on `device` (the
        card unless the caller asks for the CPU; psi's tensors move there).
        The window tensors start as copies of the unit cell, centered at
        site 0; D defaults to (and is at least) the infinite D."""
        psi = _infinite_on(psi, device)
        Dw = max(D or psi.D, psi.D)
        ALs = _padded_cells(psi.AL, L, Dw, psi.dtype)
        ARs = _padded_cells(psi.AR, L, Dw, psi.dtype)
        AC = _padded_cells(psi.AC[:1], 1, Dw, psi.dtype)[0]
        return WindowMPS(psi, FiniteMPS(ALs, ARs, AC, 0), psi)

    def grow(self, n_left: int = 0, n_right: int = 0) -> "WindowMPS":
        """Absorb n_left / n_right unit cells of the infinite sides into the
        window. The absorbed tensors are copies of the ground-state AL / AR
        cells, so the physical state is unchanged; only the mutable region
        gets larger. The bond dimension stays the window's.

        The left absorbed sites are valid ALs and the right ones valid ARs;
        their other gauges are placeholders that a center move recomputes
        before it reads them."""
        win = self.window
        Dw, dtype = win.D, win.dtype
        nl = n_left * self.left_gs.period
        nr = n_right * self.right_gs.period
        ALs = torch.cat([_padded_cells(self.left_gs.AL, nl, Dw, dtype),
                         win.ALs,
                         _padded_cells(self.right_gs.AL, nr, Dw, dtype)])
        ARs = torch.cat([_padded_cells(self.left_gs.AR, nl, Dw, dtype),
                         win.ARs,
                         _padded_cells(self.right_gs.AR, nr, Dw, dtype)])
        window = FiniteMPS(ALs, ARs, win.AC, win.center + nl)
        return WindowMPS(self.left_gs, window, self.right_gs)

    def shrink(self, n_left: int = 0, n_right: int = 0):
        """Drop n_left / n_right sites from the window edges, handing them
        back to the infinite boundaries. Returns (window, deviation).

        Exact only when the dropped tensors equal the boundary ground-state
        cells (sites added by `grow`, or edges that relaxed back to the
        ground state). A dropped tensor equals its cell only up to a bond
        gauge, so the gauge U that fits A = ref U best is extracted, folded
        into the neighbour, and only |A - ref U| counts: the deviation (a
        0-dim real tensor) is the Frobenius norm of what the move discards.
        `grow` on the leading edge with `shrink` on the trailing one gives a
        co-moving window.

        U is the least-squares fit pinv(ref) A, evaluated with the
        deviation in float64 / complex128. For an exact isometry that is the
        JAX package's ref^dag A; a float32 cell is an isometry only to
        rounding, and ref^dag A in float32 counts that defect and its own
        rounding (1.5e-5 at D=256, measured on an H100) as a deviation of an
        exact move."""
        win = self.window
        L, Dw, dtype = win.length, win.D, win.dtype
        if n_left + n_right >= L:
            raise ValueError(f"cannot drop {n_left} + {n_right} of {L} sites")
        # gauge so that dropped left sites are ALs and dropped right ones ARs
        c = min(max(win.center, n_left), L - 1 - n_right)
        win = win.move_center(c)
        ALs, ARs, AC = win.ALs, win.ARs, win.AC

        wide = torch.complex128 if dtype.is_complex else torch.float64
        dev = torch.zeros((), dtype=torch.float64, device=AC.device)
        pl = self.left_gs.period
        U = torch.eye(Dw, dtype=wide, device=AC.device)
        for i in range(n_left):
            ref = _padded_cells(self.left_gs.AL[i % pl][None], 1, Dw,
                                wide)[0]
            eff = torch.einsum("ab,bpr->apr", U, ALs[i].to(wide))
            U = torch.linalg.pinv(ref.reshape(-1, Dw)) @ eff.reshape(-1, Dw)
            dev = dev + torch.linalg.vector_norm(
                eff - torch.einsum("lpa,ab->lpb", ref, U)) ** 2
        pr = self.right_gs.period
        V = torch.eye(Dw, dtype=wide, device=AC.device)
        for i in range(n_right):
            ref = _padded_cells(self.right_gs.AR[(-1 - i) % pr][None], 1, Dw,
                                wide)[0]
            eff = torch.einsum("apr,rb->apb", ARs[L - 1 - i].to(wide), V)
            V = eff.reshape(Dw, -1) @ torch.linalg.pinv(ref.reshape(Dw, -1))
            dev = dev + torch.linalg.vector_norm(
                eff - torch.einsum("ab,bpr->apr", V, ref)) ** 2
        U, V = U.to(dtype), V.to(dtype)

        ALs = ALs[n_left: L - n_right].clone()
        ARs = ARs[n_left: L - n_right].clone()
        # fold the accumulated gauges into the new edge tensors or AC
        if n_left:
            ALs[0] = torch.einsum("ab,bpr->apr", U, ALs[0])
            if c == n_left:
                AC = torch.einsum("ab,bpr->apr", U, AC)
            else:
                ARs[0] = torch.einsum("ab,bpr->apr", U, ARs[0])
        if n_right:
            last = L - n_right - n_left - 1
            ARs[last] = torch.einsum("apr,rb->apb", ARs[last], V)
            if c == L - 1 - n_right:
                AC = torch.einsum("apr,rb->apb", AC, V)
            else:
                ALs[last] = torch.einsum("apr,rb->apb", ALs[last], V)
        window = FiniteMPS(ALs, ARs, AC, c - n_left)
        return (WindowMPS(self.left_gs, window, self.right_gs),
                torch.sqrt(dev).to(AC.real.dtype))

    def boundary_envs(self, H, H_right=None, env_init=(None, None),
                      return_envs=False):
        """(GL0, GRL): the left and right infinite environment fixed points
        padded to the window's bond dimension, the boundary environments
        of the window's sweeps.

        H_right: the right boundary's operator when it differs from the
        left one (Window-operator evolution). env_init warm-starts the two
        environment solves; with return_envs=True the infinite environment
        objects come back too, for reuse across time steps."""
        from ..environments.infinite_ham import hamiltonian_environments

        envL = hamiltonian_environments(self.left_gs, H, env_init=env_init[0])
        envR = hamiltonian_environments(self.right_gs, H_right or H,
                                        env_init=env_init[1])
        w, Dw = envL.GLs.shape[1], self.D
        GL0 = torch.zeros((w, Dw, Dw), dtype=self.dtype, device=self.device)
        Dl = self.left_gs.D
        GL0[:, :Dl, :Dl] = envL.GLs[0]
        GRL = torch.zeros((w, Dw, Dw), dtype=self.dtype, device=self.device)
        Dr = self.right_gs.D
        GRL[:, :Dr, :Dr] = envR.GRs[self.right_gs.period - 1]
        if return_envs:
            return GL0, GRL, envL, envR
        return GL0, GRL
