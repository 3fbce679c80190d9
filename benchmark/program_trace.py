"""The program's own spans (mpskit_tpu_torch/utils/trace.py) over one unit
after the window, for the span metrics of a traced run.

A stretch of the cell's work from a workload of its own (the quench's
set-up runs once more): its first unit is a lead-in, its second runs
inside `trace.recording()` and, on CUDA, under torch.profiler with the
device's activity alone, as `profiling.profile_unit`'s first unit does.
From that unit:

- `covered_s`: by span name, the wall seconds inside its spans (the union
  of their intervals); `counts`: the spans of each name;
- `idle_s`: the device's idle intervals over the unit (its wall interval
  less the merged device operations; the first and last gaps count, as in
  `idle_pct`), by the innermost span open at each one's middle, or
  NO_SPAN; `idle_in_krylov_s`: of those, the seconds with an `eigsh` or
  `expm` span open at any depth. None off CUDA.

One line on standard error gives the breakdown, and a mismatch between
the `sync` spans and the program's counter of host syncs if there is one.
The result is kept on the record, so the stretch runs once per run; it is
None for a program without spans."""

from __future__ import annotations

import bisect
import sys
import warnings

import torch

from benchmark import profiling, traffic

KRYLOV = ("eigsh", "expm")
NO_SPAN = "(no span)"


def innermost(spans) -> tuple:
    """(times, owners): from times[k] on, the innermost open span is
    owners[k] (None: no span open). The spans nest, as one thread's do."""
    times, owners, stack = [], [], []

    def pop():
        top = stack.pop()
        times.append(top.t1_ns)
        owners.append(stack[-1] if stack else None)

    for s in sorted(spans, key=lambda s: (s.t0_ns, s.id)):
        while stack and stack[-1].t1_ns <= s.t0_ns:
            pop()
        stack.append(s)
        times.append(s.t0_ns)
        owners.append(s)
    while stack:
        pop()
    return times, owners


def assign_idle(spans, t0: int, t1: int, busy) -> tuple:
    """The idle intervals of [t0, t1] outside the `busy` (start, end)
    intervals: (seconds by the name of the innermost span open at each
    one's middle, seconds with a KRYLOV span open at any depth)."""
    in_krylov = {}
    for s in sorted(spans, key=lambda s: s.id):  # parents first
        in_krylov[s.id] = s.name in KRYLOV or in_krylov.get(s.parent, False)
    times, owners = innermost(spans)
    by_name, krylov = {}, 0
    for a, b in profiling._gaps([(t0, t0), *busy, (t1, t1)]):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        k = bisect.bisect_right(times, (a + b) // 2) - 1
        owner = owners[k] if k >= 0 else None
        name = NO_SPAN if owner is None else owner.name
        by_name[name] = by_name.get(name, 0) + b - a
        if owner is not None and in_krylov[owner.id]:
            krylov += b - a
    return {k: v / 1e9 for k, v in by_name.items()}, krylov / 1e9


def _record(rec):
    try:
        from mpskit_tpu_torch.utils import trace
    except ImportError:
        return None
    from mpskit_tpu_torch.utils import sync
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(rec.device).type == "cuda"
    wl = traffic.workload(rec.cfg, rec.mix, rec.seed, rec.device)
    prof = profile(activities=[ProfilerActivity.CUDA]) if cuda else None
    recording = trace.recording()
    unit = {"profiling": False}

    def start():
        if prof is not None:
            prof.start()
            unit["profiling"] = True
            traffic.synchronize(rec.device)
        recording.__enter__()
        unit["syncs"] = sync.count
        unit["t0"] = recording.now_ns()

    def stop():
        unit["t1"] = recording.now_ns()
        unit["syncs"] = sync.count - unit["syncs"]
        recording.close()
        if prof is not None:
            prof.stop()
            unit["profiling"] = False

    try:
        with warnings.catch_warnings():
            # the profile is stopped once; its raw events are read below
            warnings.filterwarnings("ignore", "Profiler clears events")
            profiling.run_stretch(wl, {1: start, 2: stop}, rec.device)
    finally:
        recording.close()
        if unit["profiling"]:
            prof.stop()

    t0, t1, spans = unit["t0"], unit["t1"], recording.spans
    intervals = {}
    for s in spans:
        intervals.setdefault(s.name, []).append((s.t0_ns, s.t1_ns))
    out = {
        "wall_s": (t1 - t0) / 1e9,
        "covered_s": {k: profiling.merged_length(v) / 1e9
                      for k, v in intervals.items()},
        "counts": dict(recording.counts),
        "syncs": unit["syncs"],
        "idle_s": None, "idle_in_krylov_s": None,
    }
    if prof is not None:
        dev, _ = profiling._events(prof)
        out["idle_s"], out["idle_in_krylov_s"] = assign_idle(
            spans, t0, t1, [(a, b) for a, b, _ in dev])
    _report(rec.unit, out)
    return out


def _report(unit: str, out: dict) -> None:
    def listed(d):
        return ", ".join(f"{k} {v:.4f}" for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1]))

    line = f"program_trace: one {unit} {out['wall_s']:.4f} s"
    if out["idle_s"] is not None:
        line += (f"; idle {sum(out['idle_s'].values()):.4f} s by innermost "
                 f"span: {listed(out['idle_s'])}; idle in Krylov "
                 f"{out['idle_in_krylov_s']:.4f} s")
    line += (f"; inside spans (s): {listed(out['covered_s'])}; spans: "
             + ", ".join(f"{k} {v}" for k, v in sorted(out["counts"].items())))
    print(line, file=sys.stderr)
    if out["counts"].get("sync", 0) != out["syncs"]:
        print(f"program_trace: mismatch: {out['counts'].get('sync', 0)} "
              f"sync spans, {out['syncs']} counted host syncs",
              file=sys.stderr)


def unit_spans(rec):
    """The recorded unit of this run (see the module's docstring), once."""
    if not hasattr(rec, "program_trace"):
        rec.program_trace = _record(rec)
    return rec.program_trace


def _probe(rec, metric: str, unit: str):
    p = rec.probes.get(metric)
    return p if rec.unit == unit and p is not None else None


def span_share(rec, metric: str, unit: str, name: str):
    """Percent of the recorded unit's wall time inside `name` spans."""
    p = _probe(rec, metric, unit)
    if p is None or not p["counts"].get(name):
        return None
    return 100 * p["covered_s"][name] / p["wall_s"]


def span_count(rec, metric: str, unit: str, name: str):
    """The `name` spans of the recorded unit."""
    p = _probe(rec, metric, unit)
    if p is None or not p["counts"].get(name):
        return None
    return p["counts"][name]


def idle_in_krylov_share(rec, metric: str, unit: str):
    """Percent of the device's idle time in the recorded unit during which
    the host was inside a Krylov span."""
    p = _probe(rec, metric, unit)
    if p is None or p["idle_s"] is None:
        return None
    idle = sum(p["idle_s"].values())
    return 100 * p["idle_in_krylov_s"] / idle if idle > 0 else None
