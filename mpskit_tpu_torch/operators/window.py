"""A (left, middle, right) triple of operators (counterpart of
mpskit_tpu/operators/window.py).

A WindowMPS evolved under ``Window(H_left, H_mid, H_right)`` co-evolves its
infinite boundary states under ``H_left`` / ``H_right`` while the finite
window evolves under ``H_mid``; under a plain operator the boundaries stay
frozen."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Window:
    """A left/middle/right triple. ``Window(H)`` broadcasts one operator to
    all three slots."""

    left: object
    middle: object = None
    right: object = None

    def __post_init__(self):
        if self.middle is None and self.right is None:
            object.__setattr__(self, "middle", self.left)
            object.__setattr__(self, "right", self.left)
        if self.middle is None or self.right is None:
            raise ValueError("Window takes one operator or all three")

    def map(self, f):
        return Window(f(self.left), f(self.middle), f(self.right))
