"""The yardstick of the benchmark's rooflines: the published peaks of one
NVIDIA H100 SXM at 700 W (NVIDIA's data sheet, dense rates) and the least
time of each matvec the program runs, from its shapes alone."""

from __future__ import annotations

PEAK_BF16 = 989e12   # FLOP/s, bf16 tensor cores
PEAK_F32 = 67e12     # FLOP/s, float32 outside the tensor cores (TF32 off)
PEAK_BYTES = 3.35e12  # B/s, HBM3


def k1_bound(D: int, d: int, w: int) -> float:
    """Least seconds of one call of kernel K1 (the bf16 one-site matvec,
    y = GL x W GR with GL, GR (w, D, D), W (w, w, d, d), x (D, d, D), all
    float32 in memory): the larger of its two outer products on the bf16
    tensor cores and its middle contraction on the f32 units (other units,
    so they overlap), or the float32 operands read once and y written
    once."""
    ops = max(2 * (2 * w * D * D * d * D) / PEAK_BF16,
              2 * w * w * d * d * D * D / PEAK_F32)
    mem = 4 * (2 * w * D * D + w * w * d * d + 2 * D * d * D) / PEAK_BYTES
    return max(ops, mem)


def ac_bound(Dl: int, d: int, Dr: int, w: int, itemsize: int = 4) -> float:
    """Least seconds of one exact one-site matvec GL[a,x,y] W[a,b,s,t]
    x[y,t,n] GR[b,r,n] in float32 at the f32 peak: its three contractions'
    operations, or its operands and result moved once."""
    ops = (2 * w * Dl * Dl * d * Dr + 2 * w * w * d * d * Dl * Dr
           + 2 * w * Dl * d * Dr * Dr)
    nbytes = itemsize * (w * Dl * Dl + w * w * d * d + w * Dr * Dr
                         + 2 * Dl * d * Dr)
    return max(ops / PEAK_F32, nbytes / PEAK_BYTES)


def ac2_bound(Dl: int, d: int, Dr: int, w: int, itemsize: int = 4) -> float:
    """The same for the two-site matvec GL x W1 W2 GR on x (Dl, d, d, Dr)."""
    ops = (2 * w * Dl * Dl * d * d * Dr + 4 * w * w * Dl * d ** 3 * Dr
           + 2 * w * Dl * d * d * Dr * Dr)
    nbytes = itemsize * (w * Dl * Dl + 2 * w * w * d * d + w * Dr * Dr
                         + 2 * Dl * d * d * Dr)
    return max(ops / PEAK_F32, nbytes / PEAK_BYTES)
