"""GMRES operator applications in one sweep after the window: the
program's `gmres_op` count (linalg/gmres.py, the operator applications of
every linear solve, the environment walk's geometric series among them)
over the recorded sweep (benchmark/program_trace.py). Nothing for a
program that does not count them."""

from benchmark import program_trace

NAME = "gmres_matvecs.sweep"


def probe(rec):
    return program_trace.unit_spans(rec)


def read(rec):
    return program_trace.span_count(rec, NAME, "sweep", "gmres_op")
