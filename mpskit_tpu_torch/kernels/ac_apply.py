"""Kernel K1, the fused one-site effective-Hamiltonian matvec in bf16
(csrc/ac_apply_bf16.cu), its wrapper and its plain PyTorch version.

`launches` counts the wrapper's calls that launched the kernel (one per
call, however many passes run inside), and `general_launches` those of
them that took the kernel's general path (`k1_general`: every (w, d)
outside the fused tiers, `fused`); a run can reset them and read them to
show that its main path went through the kernel and which path."""

from __future__ import annotations

import ctypes
import functools

import torch

from ..parallel.replicated import is_sharded
from ..utils.trace import span
from .build import load_library

launches = 0
general_launches = 0

def ac_apply_bf16_reference(GL, W, GR, x):
    """Plain PyTorch version of K1 with the kernel's rounding points: GL, x
    and GR rounded to bf16, both products accumulated in f32, the middle
    contraction in f32 and its result t2 rounded to bf16. Run it with TF32
    off (config.matmul_precision) so that the f32 products stay f32."""
    def bf(t):
        return t.to(torch.bfloat16).to(torch.float32)

    t1 = torch.einsum("axy,ytn->axtn", bf(GL), bf(x))
    t2 = bf(torch.einsum("axtn,abst->bxsn", t1, W))
    return torch.einsum("bxsn,brn->xsr", t2, bf(GR))


@functools.cache
def _library():
    lib = load_library("ac_apply_bf16")
    lib.ac_apply_bf16_scratch_bytes.argtypes = [ctypes.c_int] * 3
    lib.ac_apply_bf16_scratch_bytes.restype = ctypes.c_size_t
    lib.ac_apply_bf16.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_size_t]
                                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.ac_apply_bf16.restype = ctypes.c_int
    lib.ac_apply_bf16_fused.argtypes = [ctypes.c_int] * 2
    lib.ac_apply_bf16_fused.restype = ctypes.c_int
    return lib


@functools.cache
def _scratch_bytes(w: int, d: int, D: int) -> int:
    """Bytes of device scratch that one launch at (w, d, D) needs; the CUDA
    source lays the buffers out and picks the kernel's path."""
    return _library().ac_apply_bf16_scratch_bytes(w, d, D)


@functools.cache
def fused(w: int, d: int) -> bool:
    """Whether K1 runs (w, d) on one of its fused tiers (the CUDA source's
    K1_TIERS) rather than on `k1_general`; asked of the library once per
    (w, d)."""
    return bool(_library().ac_apply_bf16_fused(w, d))


def _check(GL, W, GR, x):
    w, D = GL.shape[0], x.shape[0]
    d = x.shape[1] if x.dim() == 3 else 0
    shapes = {"GL": (w, D, D), "W": (w, w, d, d), "GR": (w, D, D),
              "x": (D, d, D)}
    for name, t in (("GL", GL), ("W", W), ("GR", GR), ("x", x)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"ac_apply_bf16: {name} on {t.device}, "
                             f"expected the CUDA device of x ({x.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"ac_apply_bf16: {name} is {t.dtype}, "
                            "expected torch.float32")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"ac_apply_bf16: {name} has shape "
                             f"{tuple(t.shape)}, expected {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"ac_apply_bf16: {name} is not contiguous")
    return w, d, D


def ac_apply_bf16(GL, W, GR, x):
    """y[x,s,r] = sum GL[a,x,y] x[y,t,n] W[a,b,s,t] GR[b,r,n] in bf16 with
    f32 accumulation. GL, GR (w, D, D), W (w, w, d, d), x (D, d, D), float32.

    On the CPU this is the plain version; on the card it launches K1 on the
    current stream or raises. A DTensor raises TypeError: its data_ptr() is
    a wrapper's, not the shard's (pass the gathered or local tensor).
    A launch is a `matvec` span of kind bf16 on K1's fused tiers and
    bf16-general on its general path."""
    global launches, general_launches
    if any(is_sharded(t) for t in (GL, W, GR, x)):
        raise TypeError("ac_apply_bf16 takes plain tensors, got a DTensor: "
                        "pass its full_tensor() or to_local()")
    if x.device.type == "cpu":
        return ac_apply_bf16_reference(GL, W, GR, x)
    w, d, D = _check(GL, W, GR, x)
    general = not fused(w, d)
    nbytes = _scratch_bytes(w, d, D)
    with (span("matvec", "bf16-general" if general else "bf16"),
          torch.cuda.device(x.device)):
        # torch.cuda.current_stream() builds a Stream object on every call;
        # the raw handle is what the launch takes
        stream = torch._C._cuda_getCurrentRawStream(x.device.index)
        y = torch.empty((D, d, D), dtype=torch.float32, device=x.device)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        err = _library().ac_apply_bf16(
            GL.data_ptr(), W.data_ptr(), GR.data_ptr(), x.data_ptr(),
            y.data_ptr(), scratch.data_ptr(), nbytes, w, d, D, stream)
    if err != 0:
        raise RuntimeError(f"ac_apply_bf16: kernel launch failed with CUDA "
                           f"error {err} (w={w}, d={d}, D={D})")
    launches += 1
    general_launches += general
    return y
