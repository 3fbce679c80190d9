"""Percent of a sweep's matvecs that ran on operands laid out once for
their site solve: the program's `matvec_prepared` count
(algorithms/derivatives.py ac_apply and c_apply given `prepared`) over
its `matvec` spans, counted over one sweep after the window
(benchmark/program_trace.py). Below 100 where other matvecs share the
span's name (K1's bf16 restarts). Nothing for a program that does not
count it."""

from benchmark import program_trace

NAME = "matvec_prepared_pct.sweep"


def probe(rec):
    return program_trace.unit_spans(rec)


def read(rec):
    prepared = program_trace.span_count(rec, NAME, "sweep",
                                        "matvec_prepared")
    matvecs = program_trace.span_count(rec, NAME, "sweep", "matvec")
    if prepared is None or matvecs is None:
        return None
    return 100 * prepared / matvecs
