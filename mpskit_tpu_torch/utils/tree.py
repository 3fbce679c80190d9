"""Vector-space helpers on tensors (counterpart of mpskit_tpu/utils/tree.py).

The JAX package works on pytrees; every vector on this slice's path is a
single tensor, so these are plain tensor operations returning 0-dim
tensors (no host sync)."""

from __future__ import annotations

import torch


def inner(x, y):
    """<x, y>, conjugate-linear in x."""
    return torch.vdot(x.reshape(-1), y.reshape(-1))


def norm(x):
    return torch.linalg.vector_norm(x)


def scale(a, x):
    return a * x


def add(x, y, alpha=None):
    """x + alpha * y (alpha defaults to 1)."""
    return x + y if alpha is None else x + alpha * y
