"""Percent of a sweep's wall time inside the program's `envs` spans
(environments/infinite_ham.py hamiltonian_environments: the infinite
environments' level-by-level walk with its GMRES), over one sweep after
the window (benchmark/program_trace.py). Nothing for a cell that builds
no infinite environments, or a program without the span."""

from benchmark import program_trace

NAME = "envs_span_pct.sweep"


def probe(rec):
    return program_trace.unit_spans(rec)


def read(rec):
    return program_trace.span_share(rec, NAME, "sweep", "envs")
