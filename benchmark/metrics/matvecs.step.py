"""Matvecs in one step after the window: the program's `matvec` spans
(algorithms/derivatives.py: one- and zero-site applications) counted over
the recorded step (benchmark/program_trace.py); expalg_m per exponential."""

from benchmark import program_trace

NAME = "matvecs.step"


def probe(rec):
    return program_trace.unit_spans(rec)


def read(rec):
    return program_trace.span_count(rec, NAME, "step", "matvec")
