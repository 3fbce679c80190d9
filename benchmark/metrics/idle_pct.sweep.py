"""Idle share of the device over one sweep after the window, traced by
torch.profiler with the device's activity alone (benchmark/profiling.py,
profile_unit): 100 (1 - busy / wall), busy the union of the device's
operations."""

UNIT = "sweep"


def read(rec):
    p = rec.profile
    if rec.unit != UNIT or p is None or p["busy_s"] <= 0:
        return None
    return 100 * (1 - p["busy_s"] / p["window_s"])
