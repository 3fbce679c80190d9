"""Percent of a sweep's wall time inside the program's `eigsh` spans
(linalg/lanczos.py eigsh_smallest: the site or bond eigensolves, K1
inside the one-site ones), over one sweep after the window with no
synchronization added (benchmark/program_trace.py): the inside
counterpart of eigensolve_pct.sweep."""

from benchmark import program_trace

NAME = "eigensolve_span_pct.sweep"


def probe(rec):
    return program_trace.unit_spans(rec)


def read(rec):
    return program_trace.span_share(rec, NAME, "sweep", "eigsh")
