"""The entry points that run replicated under a mesh.

Every entry point but one-site DMRG, VUMPS and the finite one-site TDVP
step (`parallel/sharded.py`) gathers a sharded argument once at entry:
`replicated_under_mesh` wraps it so that each DTensor among its arguments
(directly, or as a field of a state or environment dataclass, or in a
tuple or list) becomes its whole tensor, the entry point runs on every
rank as it does on one device, and every state or environment of the same
class in the result is handed back in the placements its input had. The
first such call of each entry point logs so at VERBOSE_WARN.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import torch

from ..config import Defaults, VERBOSE_WARN
from ..utils.logging import logger

_warned = set()


def _dtensor():
    """The DTensor class, or None while no module has imported it (then no
    DTensor exists, and a plain call pays no import)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor


def is_sharded(x) -> bool:
    cls = _dtensor()
    return cls is not None and isinstance(x, cls)


def _map_items(x, fn):
    """A tuple or list (a named tuple too) with fn applied to its items."""
    items = [fn(y) for y in x]
    return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)


def _gather(x, layouts):
    """x with its DTensors whole; layouts[(class, field)] records the mesh
    and placements of each sharded dataclass field."""
    if is_sharded(x):
        return x.full_tensor()
    if isinstance(x, (tuple, list)):
        return _map_items(x, lambda y: _gather(y, layouts))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        changes = {}
        for f in dataclasses.fields(x):
            v = getattr(x, f.name)
            if is_sharded(v):
                layouts[(type(x), f.name)] = (v.device_mesh, v.placements)
                changes[f.name] = v.full_tensor()
        return dataclasses.replace(x, **changes) if changes else x
    return x


def _reshard(x, layouts):
    from .sharded import shard_like

    if isinstance(x, (tuple, list)):
        return _map_items(x, lambda y: _reshard(y, layouts))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        changes = {}
        for f in dataclasses.fields(x):
            lay = layouts.get((type(x), f.name))
            v = getattr(x, f.name)
            if lay is not None and isinstance(v, torch.Tensor) and \
                    not is_sharded(v):
                changes[f.name] = shard_like(v, *lay)
        return dataclasses.replace(x, **changes) if changes else x
    return x


def has_sharded(*xs) -> bool:
    """Whether a DTensor is among xs, as `_gather` walks them."""
    if _dtensor() is None:
        return False
    for x in xs:
        if is_sharded(x):
            return True
        if isinstance(x, (tuple, list)) and has_sharded(*x):
            return True
        if dataclasses.is_dataclass(x) and not isinstance(x, type) and any(
                is_sharded(getattr(x, f.name))
                for f in dataclasses.fields(x)):
            return True
    return False


def run_replicated(name, fn, *args, **kwargs):
    """fn(*args, **kwargs) with its sharded arguments gathered and the
    states of its result in their inputs' placements."""
    layouts = {}
    args = _gather(args, layouts)
    kwargs = {k: _gather(v, layouts) for k, v in kwargs.items()}
    if name not in _warned and Defaults.verbosity >= VERBOSE_WARN:
        _warned.add(name)
        logger.warning("%s runs replicated under a mesh: its sharded "
                       "arguments are gathered on every rank", name)
    return _reshard(fn(*args, **kwargs), layouts)


def replicated_under_mesh(fn):
    """fn, gathering its sharded arguments once at entry (see the module
    docstring); a call without one is fn's own."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not has_sharded(*args, *kwargs.values()):
            return fn(*args, **kwargs)
        return run_replicated(fn.__name__, fn, *args, **kwargs)

    return wrapper
