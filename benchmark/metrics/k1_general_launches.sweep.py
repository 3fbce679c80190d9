"""Launches of kernel K1 on its general path per sweep over the window:
the window's calls of the one-site driver's inexact matvec
(algorithms/dmrg.py ac_apply_fast, the calls `mfu.sweep` counts), each a
K1 launch on a float32 card sweep, whose (w, d) the program's own tier
test (kernels/ac_apply.py fused, read from the CUDA source) sends to
`k1_general`: the launches by which the program's counter
kernels/ac_apply.py general_launches rose, over the sweeps the window
completed. Nothing to read without such calls in the window or on a
program without the tier test."""

import torch

COUNT = ["mpskit_tpu_torch.algorithms.dmrg:ac_apply_fast"]


def read(rec):
    if rec.unit != "sweep" or torch.device(rec.device).type != "cuda":
        return None
    from mpskit_tpu_torch.kernels import ac_apply as k1

    fused = getattr(k1, "fused", None)
    calls = [(shapes, n) for (target, shapes, dtype), n in rec.counts.items()
             if target == COUNT[0] and dtype == "torch.float32"]
    if fused is None or not calls:
        return None
    # the matvec's arguments: GL (w, D, D), W (w, w, d, d), GR, x
    general = sum(n for shapes, n in calls
                  if not fused(shapes[1][0], shapes[1][2]))
    return general / rec.units
