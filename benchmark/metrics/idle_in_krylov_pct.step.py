"""Percent of the device's idle time over one step after the window during
which the host was inside an `expm` span (the exponentials) at any depth:
the most a graph over the Krylov steps could recover. Idle intervals from
torch.profiler with the device's activity alone, laid on the program's
spans (benchmark/program_trace.py); nothing to read off CUDA."""

from benchmark import program_trace

NAME = "idle_in_krylov_pct.step"


def probe(rec):
    return program_trace.unit_spans(rec)


def read(rec):
    return program_trace.idle_in_krylov_share(rec, NAME, "step")
