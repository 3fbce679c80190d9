"""Lazy sums and (time-dependent) scalar-multiplied operators (counterpart
of mpskit_tpu/operators/lazysum.py): `LazySum`, `MultipliedOperator` and
its `TimedOperator` / `UntimedOperator` constructors. Summing and scaling
materialize through the MPOHamiltonian's `+` and scalar `*`."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence, Union


@dataclasses.dataclass(frozen=True)
class MultipliedOperator:
    """f * op where f is a number (UntimedOperator) or a callable of time
    (TimedOperator)."""

    op: Any
    f: Union[float, complex, Callable]

    @property
    def is_timed(self) -> bool:
        return callable(self.f)

    def coeff(self, t=0.0):
        return self.f(t) if callable(self.f) else self.f

    def eval_at(self, t=0.0):
        """The plain scaled operator at time t."""
        return self.coeff(t) * self.op

    def __mul__(self, a):
        if callable(self.f):
            f = self.f
            return MultipliedOperator(self.op, lambda t: a * f(t))
        return MultipliedOperator(self.op, a * self.f)

    __rmul__ = __mul__


def TimedOperator(op, f: Callable) -> MultipliedOperator:
    return MultipliedOperator(op, f)


def UntimedOperator(op, c) -> MultipliedOperator:
    return MultipliedOperator(op, c)


class LazySum:
    """A lazily evaluated sum of operators. Indexing and iteration yield the
    summands; calling it with a time evaluates the time-dependent
    coefficients into UntimedOperators."""

    def __init__(self, ops: Sequence):
        self.ops = list(ops)

    def __len__(self):
        return len(self.ops)

    def __iter__(self):
        return iter(self.ops)

    def __getitem__(self, i):
        return self.ops[i]

    @property
    def is_timed(self) -> bool:
        return any(isinstance(o, MultipliedOperator) and o.is_timed
                   for o in self.ops)

    def __call__(self, t) -> "LazySum":
        return LazySum([UntimedOperator(o.op, o.coeff(t))
                        if isinstance(o, MultipliedOperator) else o
                        for o in self.ops])

    def __add__(self, other):
        if isinstance(other, LazySum):
            return LazySum(self.ops + other.ops)
        return LazySum(self.ops + [other])

    __radd__ = __add__

    def __mul__(self, a):
        return LazySum([
            o * a if isinstance(o, MultipliedOperator) else UntimedOperator(o, a)
            for o in self.ops
        ])

    __rmul__ = __mul__

    def sum_materialized(self, t=0.0):
        """The summands at time t added eagerly (each must support +)."""
        parts = [o.eval_at(t) if isinstance(o, MultipliedOperator) else o
                 for o in self.ops]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total
