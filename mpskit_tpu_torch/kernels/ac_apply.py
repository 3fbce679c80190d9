"""Kernel K1, the fused one-site effective-Hamiltonian matvec in bf16
(csrc/ac_apply_bf16.cu), its wrapper and its plain PyTorch version.

`launches` counts the wrapper's kernel launches; a run can reset it and
read it to show that its main path went through the kernel."""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

launches = 0


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
    lib.ac_apply_bf16.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                                  + [ctypes.c_void_p])
    lib.ac_apply_bf16.restype = ctypes.c_int
    lib.ac_apply_bf16_nsplit.argtypes = [ctypes.c_int]
    lib.ac_apply_bf16_nsplit.restype = ctypes.c_int
    return lib


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
    current stream or raises."""
    global launches
    if x.device.type == "cpu":
        return ac_apply_bf16_reference(GL, W, GR, x)
    w, d, D = _check(GL, W, GR, x)
    lib = _library()
    with torch.cuda.device(x.device):
        # the kernel splits the contracted index n across blocks; each
        # split writes a partial y into this scratch, summed by pass 2
        nsplit = lib.ac_apply_bf16_nsplit(D)
        if nsplit <= 0:
            raise RuntimeError(f"ac_apply_bf16: no split plan for D={D} "
                               f"(CUDA error {-nsplit})")
        y = torch.empty((D, d, D), dtype=torch.float32, device=x.device)
        partials = torch.empty((nsplit, D, d, D), dtype=torch.float32,
                               device=x.device)
        err = lib.ac_apply_bf16(GL.data_ptr(), W.data_ptr(), GR.data_ptr(),
                                x.data_ptr(), y.data_ptr(),
                                partials.data_ptr(), w, d, D,
                                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ac_apply_bf16: kernel launch failed with CUDA "
                           f"error {err} (w={w}, d={d}, D={D})")
    launches += 1
    return y
