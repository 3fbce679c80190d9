"""Percent of a sweep's wall time inside the program's `svd` spans
(tensors/ops.py svd_truncated: DMRG2's truncated splits, cuSOLVER gesvd),
over one sweep after the window with no synchronization added
(benchmark/program_trace.py): the inside counterpart of svd_pct.sweep."""

from benchmark import program_trace

NAME = "svd_span_pct.sweep"


def probe(rec):
    return program_trace.unit_spans(rec)


def read(rec):
    return program_trace.span_share(rec, NAME, "sweep", "svd")
