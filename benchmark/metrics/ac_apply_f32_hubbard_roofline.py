"""Share of the roofline of the exact float32 one-site matvec
(mpskit_tpu_torch/algorithms/derivatives.py ac_apply: three einsums in
cuBLAS with TF32 off, as the program's sweeps run it), the matvec of
every Lanczos restart after the first, at the shape of a lattice of
spin-1/2 fermions (d = 4), with W a bulk site of the configuration's own
MPO (benchmark/reference/fermion_lattice.py): its least time at the f32
peak (benchmark/roofline.py, ac_bound) over its device time per call, by
CUDA events over 200 calls captured in one CUDA graph, after the window,
on float32 inputs drawn from the seed. Nothing to read for another
site."""

import torch

from benchmark import profiling, roofline, traffic
from benchmark.reference import fermion_lattice

CALLS = 200


def probe(rec):
    if (torch.device(rec.device).type != "cuda"
            or rec.cfg["site"]["kind"] != "spinful_fermion"):
        return None
    from mpskit_tpu_torch.algorithms.derivatives import ac_apply
    from mpskit_tpu_torch.config import matmul_precision

    L, D, d = rec.mix["L"], rec.mix["D"], rec.cfg["d"]
    W = torch.as_tensor(fermion_lattice.mpo(rec.cfg, L)[L // 2],
                        dtype=torch.float32, device=rec.device).contiguous()
    w = W.shape[0]
    gen = traffic.generator(rec.seed, 10 ** 6 + 4, rec.device)

    def rand(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=rec.device)

    GL, GR, x = rand(w, D, D), rand(w, D, D), rand(D, d, D)
    with matmul_precision():
        seconds = profiling.graph_time_s(lambda: ac_apply(GL, W, GR, x),
                                         CALLS)
    return {"seconds": seconds, "bound": roofline.ac_bound(D, d, D, w)}


def read(rec):
    p = rec.probes.get("ac_apply_f32_hubbard_roofline")
    return None if p is None else 100 * p["bound"] / p["seconds"]
