"""Device-mesh sharding for tensor-network states and environments
(counterpart of mpskit_tpu/parallel/mesh.py), on `torch.distributed`.

A mesh is a DeviceMesh with the axes ("site", "bond"), one rank per card.
A sharded state holds DTensors with the JAX package's placements: the
right virtual axis of every site tensor and the last axis of an
environment stack over "bond", the unit cell of an InfiniteMPS optionally
over "site". The DTensor is the layout the caller sees, as a sharded
`jax.Array` is in the JAX package. One-site DMRG, VUMPS and the finite
TDVP step run their own loops on its local shards
(`parallel/sharded.py`), with explicit collectives (`parallel/split.py`);
the other entry points gather a sharded state once
(`parallel/replicated.py`).

Usage, one process per card started by torchrun (or, with no process
group and no torchrun, a one-rank group that `make_mesh` starts itself):
    mesh = make_mesh(bond=4)             # or make_mesh(site=2, bond=2)
    psi = shard_finite_mps(psi, mesh)
    psi, envs, eps = find_groundstate(psi, H, DMRG())
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ensure_process_group(device_type: str) -> None:
    """A one-rank group (NCCL on "cuda", gloo on "cpu") on a free local
    port when the process has none and is not one of torchrun's ranks;
    under torchrun `init_device_mesh` starts the group from its
    environment."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass "
                           "device_type='cpu' for a mesh of CPU processes")
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return
    kw = {}
    if device_type == "cuda":
        torch.cuda.set_device(0)
        kw["device_id"] = torch.device("cuda", 0)
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
        rank=0, **kw)


def make_mesh(bond: Optional[int] = None, site: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("site", "bond") mesh over the first bond * site ranks of the
    process group; bond defaults to all ranks. Runs on the card unless the
    caller passes device_type="cpu"."""
    _ensure_process_group(device_type)
    n = dist.get_world_size()
    if bond is None and site is None:
        bond, site = n, 1
    elif bond is None:
        bond = n // site
    elif site is None:
        site = n // bond
    if bond < 1 or site < 1 or bond * site > n:
        raise ValueError(f"need {bond * site} ranks, have {n}")
    names = ("site", "bond")
    if bond * site == n:
        return init_device_mesh(device_type, (site, bond),
                                mesh_dim_names=names)
    return DeviceMesh(device_type, torch.arange(bond * site).reshape(
        site, bond), mesh_dim_names=names)


def _put(x, mesh: DeviceMesh, site, bond):
    """x as a DTensor: dimension `site` over the mesh's "site" axis and
    dimension `bond` over "bond" (None replicates)."""
    placements = [Replicate() if p is None else Shard(p % x.dim())
                  for p in (site, bond)]
    return distribute_tensor(x, mesh, placements)


def replicate(x, mesh: DeviceMesh):
    return _put(x, mesh, None, None)


def shard_finite_mps(psi, mesh: DeviceMesh):
    """Shard the right virtual-bond axis of the stacked tensors."""
    from ..states.finitemps import FiniteMPS

    return FiniteMPS(_put(psi.ALs, mesh, None, 3),
                     _put(psi.ARs, mesh, None, 3),
                     _put(psi.AC, mesh, None, 2), psi.center)


def shard_infinite_mps(psi, mesh: DeviceMesh, shard_sites: bool = False):
    """Shard bond axes (and optionally the unit-cell axis) of an
    InfiniteMPS."""
    from ..states.infinitemps import InfiniteMPS

    s = 0 if shard_sites else None
    return InfiniteMPS(_put(psi.AL, mesh, s, 3), _put(psi.AR, mesh, s, 3),
                       _put(psi.AC, mesh, s, 3), _put(psi.C, mesh, s, 2))


def shard_env(G, mesh: DeviceMesh):
    """Shard a stacked environment tensor (..., w, D, D) over its last
    axis."""
    return _put(G, mesh, None, -1)

