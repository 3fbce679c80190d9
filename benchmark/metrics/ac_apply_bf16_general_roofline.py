"""Share of kernel K1's roofline on its general path (`k1_general` in
mpskit_tpu_torch/kernels/csrc/ac_apply_bf16.cu, which every (w, d)
outside the fused tiers takes), reached through algorithms/derivatives.py
ac_apply_fast at the cell's shape, with W a bulk site of the
configuration's own MPO (benchmark/reference/lattice.py): its least time
from the published peaks (benchmark/roofline.py, k1_bound) over its device
time per call, by CUDA events over 200 calls captured in one CUDA graph,
after the window, on float32 inputs drawn from the seed. Nothing to read
unless the program counts general-path launches and the calls raised that
count by exactly the calls made."""

import torch

from benchmark import profiling, roofline, traffic
from benchmark.reference import lattice
from benchmark.reference import mps as ref

CALLS = 200


def probe(rec):
    if torch.device(rec.device).type != "cuda" or "lattice" not in rec.cfg:
        return None
    from mpskit_tpu_torch.algorithms.derivatives import ac_apply_fast
    from mpskit_tpu_torch.kernels import ac_apply as k1

    if not hasattr(k1, "general_launches"):
        return None
    L, D, d = rec.mix["L"], rec.mix["D"], rec.cfg["d"]
    W = torch.as_tensor(lattice.mpo(
        rec.cfg, L, ref.site_operators(rec.cfg["site"]))[L // 2],
                        dtype=torch.float32, device=rec.device).contiguous()
    w = W.shape[0]
    gen = traffic.generator(rec.seed, 10 ** 6 + 1, rec.device)

    def rand(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=rec.device)

    GL, GR, x = rand(w, D, D), rand(w, D, D), rand(D, d, D)
    before = k1.general_launches
    seconds = profiling.graph_time_s(lambda: ac_apply_fast(GL, W, GR, x),
                                     CALLS)
    if k1.general_launches - before != CALLS + 1:
        return None
    return {"seconds": seconds, "bound": roofline.k1_bound(D, d, w)}


def read(rec):
    p = rec.probes.get("ac_apply_bf16_general_roofline")
    return None if p is None else 100 * p["bound"] / p["seconds"]
