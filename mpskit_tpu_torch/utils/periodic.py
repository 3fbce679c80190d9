"""PeriodicArray: a mod-indexed sequence (counterpart of
mpskit_tpu/utils/periodic.py).

The port keeps unit cells as a leading axis of a stacked tensor, so
nothing inside `mpskit_tpu_torch` needs this class; it serves user code
written against MPSKit's `PeriodicArray` / `PeriodicVector`, where every
integer index wraps (0-based here; negative or past the end wraps with
`%`)."""

from __future__ import annotations

from typing import Iterable


class PeriodicArray:
    """1-D periodic view over any sequence. `p[i]` wraps i modulo len;
    slices are materialized over one period; iteration yields one period."""

    __slots__ = ("data",)

    def __init__(self, data: Iterable):
        self.data = list(data)
        if not self.data:
            raise ValueError("PeriodicArray cannot be empty")

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, i):
        if isinstance(i, slice):
            start = 0 if i.start is None else i.start
            stop = len(self.data) if i.stop is None else i.stop
            step = 1 if i.step is None else i.step
            return [self[j] for j in range(start, stop, step)]
        return self.data[int(i) % len(self.data)]

    def __setitem__(self, i, value):
        self.data[int(i) % len(self.data)] = value

    def __iter__(self):
        return iter(self.data)

    def __repr__(self) -> str:
        return f"PeriodicArray({self.data!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, PeriodicArray):
            return self.data == other.data
        return NotImplemented

    def repeat(self, n: int) -> "PeriodicArray":
        """The unit cell tiled n times."""
        return PeriodicArray(self.data * int(n))


PeriodicVector = PeriodicArray
