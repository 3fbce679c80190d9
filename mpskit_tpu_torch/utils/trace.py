"""Spans: named, nested wall-clock intervals of the port's layers, kept in
memory only while a recording is open.

    from mpskit_tpu_torch.utils import trace

    with trace.recording() as rec:
        find_groundstate(psi, H, DMRG())
    rec.spans    # Span(name, id, parent, t0_ns, t1_ns, kind), as they close
    rec.counts   # Counter of the spans by name

Each span sits inside the function whose work it measures:

    sweep   algorithms/dmrg.py, dmrg2.py: one sweep
    step    algorithms/tdvp.py: one finite TDVP step
    iteration  algorithms/vumps.py::_vumps_iteration_impl, `kind` vumps:
            one VUMPS iteration
    scan    algorithms/paramscan.py::scan_groundstate_vumps, `kind` vumps:
            one lockstep iteration, the members' `iteration` spans inside
    envs    environments/infinite_ham.py::hamiltonian_environments, `kind`
            infinite: the infinite environments' level-by-level walk
    gmres   linalg/gmres.py::linsolve_info: one linear solve
    eigsh   linalg/lanczos.py::eigsh_smallest
    expm    linalg/expm.py::expm_multiply_err
    matvec  algorithms/derivatives.py, `kind` exact, zero-site or
            two-site; kernels/ac_apply.py::ac_apply_bf16 on the card,
            `kind` bf16 (K1's fused tiers) or bf16-general (its general
            path)
    svd     tensors/ops.py::svd_truncated, `kind` gram (float32 and
            complex64 on the card: `eigh` of the float64 Gram matrix, its
            `qr` inside) or gesvd (every other call)
    qr      tensors/ops.py::qr_pos (an LQ is qr_pos of the adjoint) and
            cholesky_qr2
    push    transfermatrix/transfer.py: an MPO environment push
    sync    utils/sync.py: a counted device-to-host read
    capture linalg/graphs.py: a CUDA graph's warm-up and capture (nothing
            is recorded inside it), `kind` lanczos
    replay  linalg/graphs.py: the copies into a graph and its replay

A replayed graph runs no Python, so the spans of its work are counted
instead: `count(name, n)` adds n to `rec.counts[name]` with no span
(`linalg/lanczos.py` counts a replayed factorization's m matvecs). A
GMRES solve's operator applications are counted the same way, with no
span each: `gmres_op` (`linalg/gmres.py`, n at the end of each solve).
`svd_gram` counts the splits that take the Gram route, once each
(`tensors/ops.py::svd_truncated`).

The program's counters are plain module integers beside the code they
count: `utils.sync.count` (host syncs), `kernels.ac_apply.launches`
and `.general_launches` (launches of kernel K1, all and on its general
path), `linalg.graphs.captures` and `.replays` and
`parallel.split.collectives` (the mesh's collectives). Spans say where
the wall time went, which counters cannot.

A span's parent is the innermost span open when it opens; a span closes
when an exception passes through it. The times are nanoseconds on the
Unix-epoch clock on which torch.profiler stamps its events
(`time.perf_counter_ns()` plus one offset read when the recording
opens), so that spans can be laid on a device trace of the same process.
One recording is open at a time, from one thread.

With no recording open, `span` checks one module variable and returns a
shared no-op context, and `count` returns: no allocation and no clock
read."""

from __future__ import annotations

import collections
import contextlib
import time
from typing import NamedTuple, Optional


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]   # the id of the enclosing span, None at the root
    t0_ns: int
    t1_ns: int
    kind: Optional[str] = None


_NULL = contextlib.nullcontext()
_open = None  # the open recording, or None


def span(name: str, kind: Optional[str] = None):
    """A context that records one span while a recording is open."""
    if _open is None:
        return _NULL
    return _Timed(_open, name, kind)


def count(name: str, n: int = 1) -> None:
    """Add n to the open recording's count of `name`, with no span."""
    if _open is not None:
        _open.counts[name] += n


@contextlib.contextmanager
def paused():
    """Record nothing while open, for work that does not stand for itself
    (a CUDA graph's warm-up and capture)."""
    global _open
    rec, _open = _open, None
    try:
        yield
    finally:
        _open = rec


class _Timed:
    __slots__ = ("rec", "name", "kind", "id", "parent", "t0")

    def __init__(self, rec, name, kind):
        self.rec, self.name, self.kind = rec, name, kind

    def __enter__(self):
        rec = self.rec
        self.id = rec._next
        rec._next += 1
        self.parent = rec._stack[-1] if rec._stack else None
        rec._stack.append(self.id)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        rec._stack.pop()
        rec.spans.append(Span(self.name, self.id, self.parent,
                              self.t0 + rec.offset_ns, t1 + rec.offset_ns,
                              self.kind))
        rec.counts[self.name] += 1
        return False


class recording:
    """The spans of the code run while it is open: `with recording() as
    rec:` (a context manager class, lower-case as contextlib's are)."""

    def __init__(self):
        self.spans = []
        self.counts = collections.Counter()
        self._stack = []
        self._next = 0
        self.offset_ns = 0

    def now_ns(self) -> int:
        """The present time on the spans' clock."""
        return time.perf_counter_ns() + self.offset_ns

    def __enter__(self):
        global _open
        if _open is not None:
            raise RuntimeError("a recording is open already")
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        _open = self
        return self

    def close(self) -> None:
        """Stop recording (a no-op once stopped)."""
        global _open
        if _open is self:
            _open = None

    def __exit__(self, *exc):
        self.close()
        return False

