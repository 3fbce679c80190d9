"""The layouts of a sharded state (`parallel.mesh`) and the local tensors
that the main loops run on when they are handed a
`parallel.split.BondSplit`: the one-site DMRG sweep
(`algorithms.dmrg._dmrg_sweep_impl`), the finite TDVP step
(`algorithms.tdvp._timestep_finite`) and the VUMPS iteration
(`algorithms.vumps._vumps_iteration_impl`). Their entry points
(`find_groundstate_dmrg`, `timestep`, `find_groundstate_vumps`) take a
sharded state through these conversions and run their own loops on it:

- DMRG and TDVP keep the stacks of a finite chain (ALs, ARs and the left
  and right environments) as this rank's columns of the bond axis, so a
  rank holds 1/bond of them; the center tensor, the environment carried
  through the sweep and the Krylov vectors are whole on every rank
  (`FiniteShards`).
- VUMPS holds the state and its environments whole; the environment walk
  and the local solves run split over "bond", and with the unit cell
  sharded over "site" each "site" rank solves its own sites' AC and C and
  the solutions are all-gathered (`InfiniteShards`).

The outputs carry the input's placements.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..environments.finite import FiniteEnv
from ..environments.infinite_ham import InfiniteHamEnv
from ..states.finitemps import FiniteMPS
from ..states.infinitemps import InfiniteMPS
from .split import BondSplit, MeshAxis

_INFINITE_FIELDS = ("AL", "AR", "AC", "C")


def shard_like(x, mesh, placements):
    """A whole tensor, identical on every rank, as a DTensor with these
    placements: each rank keeps its chunk, no data moves."""
    local = x
    for dim, p in enumerate(placements):
        if p.is_shard():
            ax = p.dim % x.dim()
            local = local.chunk(mesh.size(dim), dim=ax)[
                mesh.get_local_rank(dim)]
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def _from_local(local, mesh, like=None):
    """This rank's columns of a bond-sharded stack as a DTensor, in the
    placements of `like` (a DTensor of the caller) if given."""
    n = mesh.size(mesh.mesh_dim_names.index("bond"))
    shape = local.shape[:-1] + (local.shape[-1] * n,)
    local = local.contiguous()
    out = DTensor.from_local(
        local, mesh, [Replicate(), Shard(local.dim() - 1)], run_check=False,
        shape=shape, stride=torch.empty(shape, device="meta").stride())
    if like is not None and tuple(like.placements) != tuple(out.placements):
        out = out.redistribute(mesh, like.placements)
    return out


def _local(x, mesh):
    """This rank's columns of a DTensor's last axis, whatever its
    placements."""
    placements = [Replicate(), Shard(x.dim() - 1)]
    return x.redistribute(mesh, placements).to_local()


class FiniteShards:
    """A bond-sharded FiniteMPS `psi`: the BondSplit of its bond axis, and
    the conversions between states in its placements and the local stacks
    of the sweep and the step."""

    def __init__(self, psi: FiniteMPS):
        self.psi, self.mesh = psi, psi.AC.device_mesh
        self.split = BondSplit(self.mesh, psi.D)

    def locals(self, psi: FiniteMPS):
        """Copies of (ALs, ARs) as this rank's columns and AC whole, at
        center 0."""
        if psi.center != 0:
            whole = FiniteMPS(psi.ALs.full_tensor(), psi.ARs.full_tensor(),
                              psi.AC.full_tensor(), psi.center).move_center(0)
            return (self.split.local(whole.ALs).clone(),
                    self.split.local(whole.ARs).clone(), whole.AC)
        return (_local(psi.ALs, self.mesh).clone(),
                _local(psi.ARs, self.mesh).clone(), psi.AC.full_tensor())

    def state(self, ALs, ARs, AC) -> FiniteMPS:
        """The local stacks as a center-0 state in the placements of
        `psi`."""
        return FiniteMPS(_from_local(ALs, self.mesh, self.psi.ALs),
                         _from_local(ARs, self.mesh, self.psi.ARs),
                         shard_like(AC, self.mesh, self.psi.AC.placements), 0)

    def envs(self, GLs, GRs) -> FiniteEnv:
        """Local environment stacks as DTensors sharded over "bond" on
        their last axis."""
        return FiniteEnv(_from_local(GLs, self.mesh),
                         _from_local(GRs, self.mesh))


class InfiniteShards:
    """A sharded InfiniteMPS `psi` (bond axes over "bond", the unit cell
    over "site" if its placements say so): its BondSplit, its "site" axis
    (None when the cell is not sharded), and the conversions between states
    in its placements and whole tensors."""

    def __init__(self, psi: InfiniteMPS):
        self.psi, self.mesh = psi, psi.AL.device_mesh
        self.split = BondSplit(self.mesh, psi.D)
        self.site = (MeshAxis(self.mesh, "site")
                     if psi.AL.placements[0].is_shard() else None)

    @staticmethod
    def whole(psi: InfiniteMPS) -> InfiniteMPS:
        return InfiniteMPS(*(getattr(psi, f).full_tensor()
                             for f in _INFINITE_FIELDS))

    def state(self, q: InfiniteMPS) -> InfiniteMPS:
        """A whole state in the placements of `psi`."""
        return InfiniteMPS(*(shard_like(getattr(q, f), self.mesh,
                                        getattr(self.psi, f).placements)
                             for f in _INFINITE_FIELDS))

    def envs(self, envs: InfiniteHamEnv) -> InfiniteHamEnv:
        """The environment stacks as DTensors sharded over "bond" on their
        last axis."""
        placements = (Replicate(), Shard(envs.GLs.dim() - 1))
        return InfiniteHamEnv(shard_like(envs.GLs, self.mesh, placements),
                              shard_like(envs.GRs, self.mesh, placements),
                              envs.e_density, envs.resid)
