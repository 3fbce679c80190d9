"""Matvecs in one sweep after the window: the program's `matvec` spans
(algorithms/derivatives.py: exact, bf16 K1 and two-site applications)
counted over the recorded sweep (benchmark/program_trace.py)."""

from benchmark import program_trace

NAME = "matvecs.sweep"


def probe(rec):
    return program_trace.unit_spans(rec)


def read(rec):
    return program_trace.span_count(rec, NAME, "sweep", "matvec")
