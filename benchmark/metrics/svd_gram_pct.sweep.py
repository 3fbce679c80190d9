"""Percent of a sweep's truncated splits that took the Gram route: the
program's `svd_gram` count (tensors/ops.py svd_truncated, float32 and
complex64 on the card) over its `svd` spans, counted over one sweep after
the window (benchmark/program_trace.py). Nothing for a program that does
not count the route."""

from benchmark import program_trace

NAME = "svd_gram_pct.sweep"


def probe(rec):
    return program_trace.unit_spans(rec)


def read(rec):
    grams = program_trace.span_count(rec, NAME, "sweep", "svd_gram")
    svds = program_trace.span_count(rec, NAME, "sweep", "svd")
    if grams is None or svds is None:
        return None
    return 100 * grams / svds
