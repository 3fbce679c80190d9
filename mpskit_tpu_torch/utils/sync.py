"""Counted device-to-host reads.

Every data-dependent branch of the port (a Lanczos exit test, a restart
decision, a sweep's residual) reads device scalars on the host, which
waits for the device. All such reads go through `to_host`, so that
`count` is the number of host syncs a run made: the first known overhead
of the eager port, and what a later CUDA-graph capture has to remove.
Each read is also a `sync` span (utils/trace.py): the host's wait."""

from __future__ import annotations

import functools

import numpy as np
import torch

from .trace import span

count = 0


def to_host(*xs) -> list:
    """The values of 0-dim tensors as Python numbers, in one transfer."""
    global count
    count += 1
    with span("sync"):
        if len(xs) == 1:
            return [xs[0].item()]
        return torch.stack([torch.as_tensor(x) for x in xs]).tolist()


def to_host_array(*xs) -> np.ndarray:
    """Tensors of any shape, flattened and joined in one transfer, as a
    numpy array of their common dtype (e.g. an Arnoldi column and its
    subdiagonal norm)."""
    global count
    count += 1
    with span("sync"):
        dtype = functools.reduce(torch.promote_types,
                                 (x.dtype for x in xs))
        flat = torch.cat([x.reshape(-1).to(dtype) for x in xs])
        return flat.cpu().resolve_conj().numpy()
