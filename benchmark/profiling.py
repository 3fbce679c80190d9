"""What a traced run reads besides the window: a split of a few units by
synchronizations around named program functions, calls counted by shape,
one unit under torch.profiler (busy time from the merged device
intervals, the largest device operations, the idle gaps by what the host
was doing), and a kernel timed with CUDA events over a CUDA graph."""

from __future__ import annotations

import bisect
import collections
import contextlib
import importlib
import time
import warnings

import torch

from benchmark.traffic import synchronize


class StretchEnd(Exception):
    """Raised from a unit's end to stop the work it is part of."""


def run_stretch(wl, calls: dict, device):
    """Run the workload's work, keeping nothing, until the last unit that
    `calls` names ends: calls[k]() at the end of unit k (counting from 1),
    after a synchronization."""
    n, last = 0, max(calls)

    def on_unit():
        nonlocal n
        synchronize(device)
        n += 1
        if n in calls:
            calls[n]()
        if n == last:
            raise StretchEnd

    with contextlib.suppress(StretchEnd):
        while True:
            wl.work(on_unit, keep=False)


def _resolve(target: str):
    module, attr = target.split(":")
    return importlib.import_module(module), attr


@contextlib.contextmanager
def patched(targets, make):
    """Replace each "module:attribute" of `targets` by make(target, fn)
    while the block runs."""
    saved = []
    try:
        for t in targets:
            mod, attr = _resolve(t)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, make(t, fn))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


@contextlib.contextmanager
def counted(targets, counts: collections.Counter):
    """Count the calls of each target by (target, argument shapes, dtype
    of the last tensor argument)."""
    def make(t, fn):
        def call(*args, **kwargs):
            shapes = tuple(tuple(a.shape) for a in args
                           if isinstance(a, torch.Tensor))
            dt = next((str(a.dtype) for a in reversed(args)
                       if isinstance(a, torch.Tensor)), "")
            counts[(t, shapes, dt)] += 1
            return fn(*args, **kwargs)
        return call

    with patched(targets, make):
        yield


def split(wl, targets, units: int, device) -> dict:
    """Seconds inside each target, with a synchronization at each edge of
    every call, over `units` units (from the end of one unit to the end of
    the units-th after it), and the stretch's wall seconds."""
    parts = {t: 0.0 for t in targets}
    span = {}
    active = False

    def make(t, fn):
        def call(*args, **kwargs):
            if not active:
                return fn(*args, **kwargs)
            synchronize(device)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                synchronize(device)
                parts[t] += time.perf_counter() - t0
        return call

    def start():
        nonlocal active
        active = True
        span["t0"] = time.perf_counter()

    def stop():
        nonlocal active
        active = False
        span["t1"] = time.perf_counter()

    with patched(targets, make):
        run_stretch(wl, {1: start, 1 + units: stop}, device)
    return {"parts": parts, "seconds": span["t1"] - span["t0"]}


def merged_length(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _gaps(intervals):
    """The gaps between the merged intervals, as (start, end)."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def _innermost(ops, starts, t):
    """Name of the latest-started host operation still running at t."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(i - 4096, -1), -1):
        s, e, name = ops[j]
        if e >= t:
            best = name
            break
    return best or "(no operation: Python)"


def _short(name: str) -> str:
    """A C++ kernel's name without its template and argument lists."""
    if name.startswith("void ") or "::" in name:
        for sep in ("<", "("):
            name = name.split(sep, 1)[0].strip() or name
    return name[:120]


def _events(prof):
    """(device operations, host operations) of a finished profile as
    (start ns, end ns, name), from the raw events: parsing them into
    Python event objects would take minutes for the ~10^6 device
    operations of a two-site sweep."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        item = (s, s + e.duration_ns(), e.name())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(item)
        else:
            host.append(item)
    return dev, sorted(host)


def profile_unit(wl, device) -> dict:
    """Two units after the window (the second and third of a stretch)
    under torch.profiler. The first records the device's operations
    alone: its busy seconds (the union of the operations), its wall
    seconds and the ten largest operations. The second records the host's
    operations too, which slows a launch-bound unit, so it gives only the
    ten host operations behind the most idle time (the innermost one
    running at the middle of each gap between device operations)."""
    from torch.profiler import ProfilerActivity, profile

    device_only = profile(activities=[ProfilerActivity.CUDA])
    with_host = profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
    span = {}

    def start():
        device_only.start()
        synchronize(device)
        span["t0"] = time.perf_counter()

    def switch():
        span["t1"] = time.perf_counter()
        device_only.stop()
        with_host.start()

    with warnings.catch_warnings():
        # each profile is stopped once; the raw events are read below
        warnings.filterwarnings("ignore", "Profiler clears events")
        run_stretch(wl, {1: start, 2: switch, 3: with_host.stop}, device)
    dev, _ = _events(device_only)
    by_name = collections.Counter()
    for a, b, name in dev:
        by_name[name] += b - a
    dev_h, host = _events(with_host)
    starts = [h[0] for h in host]
    idle = collections.Counter()
    for a, b in _gaps([(a, b) for a, b, _ in dev_h]):
        idle[_innermost(host, starts, (a + b) // 2)] += b - a
    return {
        "busy_s": merged_length([(a, b) for a, b, _ in dev]) / 1e9,
        "window_s": span["t1"] - span["t0"],
        "device_ops": [[_short(k), v / 1e9]
                       for k, v in by_name.most_common(10)],
        "idle_gaps": [[k, v / 1e9] for k, v in idle.most_common(10)],
    }


def cuda_time_s(fn, n: int) -> float:
    """Device seconds per call of fn over n calls in a row, by CUDA events,
    after one call to warm up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3 / n


def graph_time_s(fn, n: int) -> float:
    """Device seconds per call of fn: n calls captured in one CUDA graph
    and replayed, so that the host's launch work is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_time_s(graph.replay, 3) / n


def split_share(rec, unit: str, targets) -> float | None:
    """Percent of a split's wall seconds spent inside `targets`, for a
    cell whose unit is `unit` (None otherwise)."""
    if rec.unit != unit or rec.split is None:
        return None
    return 100 * sum(rec.split["parts"][t] for t in targets) / rec.split[
        "seconds"]
