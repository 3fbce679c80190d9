"""Percent of a step's Lanczos exponentials that ran as a CUDA graph
replay: the program's `replay` spans (linalg/graphs.py) over its `expm`
spans (linalg/expm.py expm_multiply_err), counted over one step after the
window (benchmark/program_trace.py). Nothing for a program that replays
no graph."""

from benchmark import program_trace

NAME = "expm_replay_pct.step"


def probe(rec):
    return program_trace.unit_spans(rec)


def read(rec):
    replays = program_trace.span_count(rec, NAME, "step", "replay")
    expms = program_trace.span_count(rec, NAME, "step", "expm")
    if replays is None or expms is None:
        return None
    return 100 * replays / expms
