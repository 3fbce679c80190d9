"""Percent of a step's wall time inside the program's `expm` spans
(linalg/expm.py expm_multiply_err: TDVP's Lanczos exponentials), over one
step after the window with no synchronization added
(benchmark/program_trace.py): the inside counterpart of expm_pct.step."""

from benchmark import program_trace

NAME = "expm_span_pct.step"


def probe(rec):
    return program_trace.unit_spans(rec)


def read(rec):
    return program_trace.span_share(rec, NAME, "step", "expm")
