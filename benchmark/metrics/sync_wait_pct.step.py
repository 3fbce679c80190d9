"""Percent of a step's wall time in which the host was blocked in the
program's device reads: the `sync` spans of utils/sync.py (to_host,
to_host_array, one per count of host_syncs), over one step after the
window (benchmark/program_trace.py)."""

from benchmark import program_trace

NAME = "sync_wait_pct.step"


def probe(rec):
    return program_trace.unit_spans(rec)


def read(rec):
    return program_trace.span_share(rec, NAME, "step", "sync")
