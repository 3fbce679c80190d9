"""The whole sweep's share of the card's peak: the least time of every
matvec the window ran (counted by shape: K1 calls at k1_bound, exact
float32 one- and two-site matvecs at the f32 peak, benchmark/roofline.py)
over the window's wall time. A lower bound of the work, since it leaves
out the QRs, SVDs, environment pushes and Krylov vector operations;
nothing to read in a cell that runs no float32 sweep on the card."""

import torch

from benchmark import roofline

COUNT = [
    "mpskit_tpu_torch.algorithms.dmrg:ac_apply",
    "mpskit_tpu_torch.algorithms.dmrg:ac_apply_fast",
    "mpskit_tpu_torch.algorithms.dmrg2:ac2_apply",
]


def _least_seconds(target, shapes, dtype):
    if dtype != "torch.float32":
        return None
    fn = target.split(":")[1]
    if fn == "ac2_apply":
        (w, Dl, _), _, _, (_, Dr, _), (_, d, _, _) = shapes
        return roofline.ac2_bound(Dl, d, Dr, w)
    (w, Dl, _), _, (_, Dr, _), (_, d, _) = shapes
    if fn == "ac_apply_fast":
        return roofline.k1_bound(Dl, d, w)
    return roofline.ac_bound(Dl, d, Dr, w)


def read(rec):
    if rec.unit != "sweep" or torch.device(rec.device).type != "cuda":
        return None
    total = 0.0
    for (target, shapes, dtype), n in rec.counts.items():
        least = _least_seconds(target, shapes, dtype)
        if least is None:
            return None
        total += n * least
    return 100 * total / rec.window_s if total > 0 else None
