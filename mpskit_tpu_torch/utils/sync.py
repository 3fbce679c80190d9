"""Counted device-to-host reads.

Every data-dependent branch of the port (a Lanczos exit test, a restart
decision, a sweep's residual) reads device scalars on the host, which
waits for the device. All such reads go through `to_host`, so that
`count` is the number of host syncs a run made: the first known overhead
of the eager port, and what a later CUDA-graph capture has to remove."""

from __future__ import annotations

import torch

count = 0


def to_host(*xs) -> list:
    """The values of 0-dim tensors as Python numbers, in one transfer."""
    global count
    count += 1
    if len(xs) == 1:
        return [xs[0].item()]
    return torch.stack([torch.as_tensor(x) for x in xs]).tolist()
