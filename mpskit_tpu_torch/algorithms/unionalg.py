"""Algorithm chaining with ``&`` (counterpart of
mpskit_tpu/algorithms/unionalg.py): ``alg1 & alg2`` applies the stages in
sequence, threading the state from one into the next. Environments are not
handed across a stage boundary; each stage rebuilds its own from the
incoming state."""

from __future__ import annotations

import dataclasses


class Chainable:
    """Mixin giving algorithm structs the ``&`` composition."""

    def __and__(self, other):
        tail = other.algs if isinstance(other, ChainedAlg) else (other,)
        return ChainedAlg((self,) + tuple(tail))


@dataclasses.dataclass(frozen=True)
class ChainedAlg(Chainable):
    """A sequence of algorithms applied one after the other."""

    algs: tuple

    def __and__(self, other):
        tail = other.algs if isinstance(other, ChainedAlg) else (other,)
        return ChainedAlg(tuple(self.algs) + tuple(tail))

    def __iter__(self):
        return iter(self.algs)

    def __len__(self):
        return len(self.algs)


# reference-name alias
UnionAlg = ChainedAlg
