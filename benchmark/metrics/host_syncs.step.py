"""Host syncs per step: the program's counted device-to-host reads
(mpskit_tpu_torch/utils/sync.py, count) over the window, over the steps
the window completed."""

UNIT = "step"


def read(rec):
    return rec.syncs / rec.units if rec.unit == UNIT else None
