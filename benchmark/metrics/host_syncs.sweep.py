"""Host syncs per sweep: the program's counted device-to-host reads
(mpskit_tpu_torch/utils/sync.py, count) over the window, over the sweeps
the window completed."""

UNIT = "sweep"


def read(rec):
    return rec.syncs / rec.units if rec.unit == UNIT else None
