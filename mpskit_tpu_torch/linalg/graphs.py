"""Bound operators and the CUDA graphs of fixed-trip Krylov work.

`Bound(fn, *operands)` is the matvec x -> fn(*operands, x) with its
operands in sight: a solver handed one can copy them into the static
buffers of a captured CUDA graph, which a lambda's closure hides from it.
Called, it runs fn exactly as the lambda would.

`replayed(key, body, inputs)` runs `body(*inputs)` as one CUDA graph: the
first call for a key captures body on static copies of the inputs, and
every call copies the inputs into those buffers and replays the graph. A
replay enqueues the whole of body at once, with no Python between its
kernels. The outputs are the graph's own static tensors, overwritten by
the next replay of the key. The last _CACHE_SIZE keys keep their graphs
(a finite TDVP step makes five: three operand layouts of its one-site
exponentials, two of its zero-site ones).

Spans (utils/trace.py): `capture` around a key's warm-up and capture,
inside which nothing is recorded (that work is not the work it stands
for), and `replay` around the copies and the replay. Counters: `captures`
and `replays`."""

from __future__ import annotations

import collections

import torch

from ..utils import trace

captures = 0
replays = 0

_CACHE_SIZE = 16
_graphs = collections.OrderedDict()  # key -> (graph, static inputs, outputs)


class Bound:
    """The matvec x -> fn(*operands, x)."""

    __slots__ = ("fn", "operands")

    def __init__(self, fn, *operands):
        self.fn, self.operands = fn, operands

    def __call__(self, x):
        return self.fn(*self.operands, x)


def capturable(matvec, v0) -> bool:
    """Whether a factorization of matvec from v0 can run as a graph: a
    Bound matvec whose operands and v0 are plain CUDA tensors (not
    DTensors, whose collectives a graph does not hold)."""
    if not isinstance(matvec, Bound):
        return False
    return all(type(t) is torch.Tensor and t.is_cuda
               for t in (*matvec.operands, v0))


def signature(*xs) -> tuple:
    """The shape, strides, dtype and device of each tensor, for a graph's
    key. The strides are in it because the static copies keep them: the
    library calls a product makes depend on its operands' layout (a
    transposed operand is read in place), so that a graph replays the
    kernels the eager call would launch, bit for bit."""
    return tuple((tuple(x.shape), x.stride(), x.dtype, x.device)
                 for x in xs)


def _capture(body, inputs):
    """(graph, static inputs, outputs) of body captured on copies of the
    inputs in their layout, after one warm-up run on a side stream."""
    with torch.cuda.device(inputs[0].device):
        statics = [x.clone() for x in inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body(*statics)  # creates the library handles and workspaces
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outputs = body(*statics)
    return graph, statics, outputs


def replayed(key, body, inputs, kind=None):
    """body(*inputs) through the graph of `key` (captured on its first
    call); `kind` labels the `replay` span."""
    global captures, replays
    entry = _graphs.get(key)
    if entry is None:
        with trace.span("capture", kind), trace.paused():
            entry = _capture(body, inputs)
        captures += 1
        _graphs[key] = entry
        if len(_graphs) > _CACHE_SIZE:
            _graphs.popitem(last=False)
    else:
        _graphs.move_to_end(key)
    graph, statics, outputs = entry
    with trace.span("replay", kind):
        for s, x in zip(statics, inputs):
            s.copy_(x)
        graph.replay()
    replays += 1
    return outputs
