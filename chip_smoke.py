#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mpskit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles kernel K1 (kernels/csrc/ac_apply_bf16.cu) with nvcc;
  3. K1 check: the kernel against its plain PyTorch version and against the
     exact f32 matvec at D=512 and at a ragged D=200 (w=3, d=2), and both
     timed with CUDA events at D=512;
  4. f64 parity: DMRG on TFIM L=16 D=32 in float64 against the closed-form
     ground energy (covers QR of the padded rank-deficient edge panels);
  5. the slice at full width: find_groundstate with DMRG(krylovdim=10,
     eig_maxrestarts=2, cheap_galerkin=True) on TFIM L=32 D=512 float32,
     against the closed-form energy, with K1's launch count from this run.
The last two lines are a JSON object describing each kernel and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
K1_SOURCE = "mpskit_tpu_torch/kernels/csrc/ac_apply_bf16.cu"
K1_REPLACES = "scripts/exp_r5_bf16_matvec.py:66"
K1_TOL_PLAIN = 1e-3   # same rounding points; f32 summation order differs
K1_TOL_EXACT = 1e-2   # bf16 operands: ~3e-3 expected
E_TOL_F64 = 1e-8      # absolute, float64
E_TOL_F32 = 1e-5      # relative, float32 with a bf16 first restart


def tfim_open_chain_e0(L: int, g: float) -> float:
    """Ground energy of H = -sum Z Z - g sum X on an open chain of L sites:
    minus the sum of the singular values of g*I + superdiag(1) (free
    fermions)."""
    A = g * np.eye(L) + np.diag(np.ones(L - 1), 1)
    return -float(np.linalg.svd(A, compute_uv=False).sum())


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, n: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs the GPU")
    if not (REPO / "mpskit_tpu_torch").is_dir():
        raise SystemExit(f"chip_smoke: no mpskit_tpu_torch package in {REPO}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")


def phase_build():
    from mpskit_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library("ac_apply_bf16")
    log(f"[build] K1 built and loaded in {time.perf_counter() - t0:.1f} s")
    for report in build.BUILD_DIR.glob("libac_apply_bf16_*.ptxas.txt"):
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] ptxas: {line.strip()}")


def phase_k1():
    import torch
    from mpskit_tpu_torch.algorithms.derivatives import ac_apply
    from mpskit_tpu_torch.config import matmul_precision
    from mpskit_tpu_torch.kernels.ac_apply import (
        ac_apply_bf16, ac_apply_bf16_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    w, d = 3, 2
    out = {"max_abs_err": 0.0}
    with matmul_precision():
        for D in (512, 200):
            def randn(*shape):
                return torch.randn(shape, generator=gen, device="cuda")

            GL, GR = randn(w, D, D) / D, randn(w, D, D) / D
            W, x = randn(w, w, d, d), randn(D, d, D)
            y = ac_apply_bf16(GL, W, GR, x)
            y_plain = ac_apply_bf16_reference(GL, W, GR, x)
            y_exact = ac_apply(GL, W, GR, x)
            torch.cuda.synchronize()
            if not torch.isfinite(y).all():
                raise RuntimeError(f"K1 output not finite at D={D}")
            rel_plain = float((y - y_plain).norm() / y_plain.norm())
            rel_exact = float((y - y_exact).norm() / y_exact.norm())
            abs_err = float((y - y_plain).abs().max())
            log(f"[k1] D={D}: rel err vs plain {rel_plain:.3e} "
                f"(tol {K1_TOL_PLAIN}), vs exact f32 {rel_exact:.3e} "
                f"(tol {K1_TOL_EXACT}), max abs err vs plain {abs_err:.3e}")
            if not (rel_plain <= K1_TOL_PLAIN and rel_exact <= K1_TOL_EXACT):
                raise RuntimeError(f"K1 disagrees with its references at D={D}")
            out["max_abs_err"] = max(out["max_abs_err"], abs_err)
            if D == 512:
                # plain, kernel, kernel, plain: both sides see the same drift
                n = 50
                times = [cuda_time_ms(lambda: f(GL, W, GR, x), n)
                         for f in (ac_apply_bf16_reference, ac_apply_bf16,
                                   ac_apply_bf16, ac_apply_bf16_reference)]
                out["plain_ms"] = (times[0] + times[3]) / 2
                out["ms"] = (times[1] + times[2]) / 2
                exact_ms = cuda_time_ms(lambda: ac_apply(GL, W, GR, x), n)
                log(f"[k1] D=512 w=3 d=2 time per matvec: kernel "
                    f"{out['ms']:.4f} ms, plain bf16 version "
                    f"{out['plain_ms']:.4f} ms, exact f32 ac_apply "
                    f"{exact_ms:.4f} ms (runs: {', '.join(f'{t:.4f}' for t in times)})")
    return out


def phase_f64():
    import torch
    from mpskit_tpu_torch import (
        FiniteMPS, expectation_value, find_groundstate,
        transverse_field_ising_lattice,
    )

    L, g = 16, 1.5
    gen = torch.Generator(device="cuda").manual_seed(1)
    psi = FiniteMPS.random(L, 2, 32, torch.float64, "cuda", gen)
    H = transverse_field_ising_lattice(g=g)
    t0 = time.perf_counter()
    psi, envs, eps = find_groundstate(psi, H)
    E = float(expectation_value(psi, H, envs))
    e0 = tfim_open_chain_e0(L, g)
    log(f"[f64] TFIM L={L} D=32 g={g}: E={E:.15f} E0={e0:.15f} "
        f"|dE|={abs(E - e0):.3e} (tol {E_TOL_F64}), eps={eps:.2e}, "
        f"{time.perf_counter() - t0:.1f} s")
    if not abs(E - e0) <= E_TOL_F64:
        raise RuntimeError("float64 DMRG energy misses the closed form")


def phase_slice():
    import torch
    from mpskit_tpu_torch import (
        DMRG, FiniteMPS, expectation_value, find_groundstate,
        transverse_field_ising_lattice,
    )
    from mpskit_tpu_torch.kernels import ac_apply as k1
    from mpskit_tpu_torch.utils import sync

    L, d, D, g, sweeps = 32, 2, 512, 1.5, 8
    gen = torch.Generator(device="cuda").manual_seed(2)
    psi = FiniteMPS.random(L, d, D, torch.float32, "cuda", gen)
    H = transverse_field_ising_lattice(g=g)
    marks = []

    def mark(it, psi, H):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), sync.count))

    alg = DMRG(krylovdim=10, eig_maxrestarts=2, cheap_galerkin=True,
               maxiter=sweeps, finalize=mark, verbosity=0)
    torch.cuda.synchronize()
    k1.launches = 0
    sync.count = 0
    marks.append((time.perf_counter(), 0))
    psi, envs, eps = find_groundstate(psi, H, alg)
    torch.cuda.synchronize()
    launches = k1.launches
    E = float(expectation_value(psi, H, envs))
    E_fresh = float(expectation_value(psi, H))
    e0 = tfim_open_chain_e0(L, g)
    for k in range(1, len(marks)):
        log(f"[slice] sweep {k}: {marks[k][0] - marks[k - 1][0]:.3f} s, "
            f"{marks[k][1] - marks[k - 1][1]} host syncs")
    log(f"[slice] K1 launches in the run: {launches}, host syncs: "
        f"{sync.count} over {len(marks) - 1} sweeps")
    rel = abs(E - e0) / abs(e0)
    log(f"[slice] TFIM L={L} D={D} float32: E={E:.8f} (fresh envs "
        f"{E_fresh:.8f}) E0={e0:.8f} rel err {rel:.3e} (tol {E_TOL_F32}), "
        f"eps={eps:.2e}")
    if not torch.isfinite(psi.AC).all() or psi.AC.shape != (D, d, D):
        raise RuntimeError("the DMRG state is not finite or has a wrong shape")
    if not rel <= E_TOL_F32:
        raise RuntimeError("float32 DMRG energy misses the closed form")
    if not abs(E - E_fresh) <= E_TOL_F32 * abs(e0):
        raise RuntimeError("the returned environments disagree with fresh ones")
    if launches <= 0:
        raise RuntimeError("the main path never launched K1")
    return launches


def main():
    sys.path.insert(0, str(REPO))
    phase_device()
    import torch

    phase_build()
    k1 = phase_k1()
    phase_f64()
    launches = phase_slice()
    log(json.dumps({"kernels": [{
        "name": "ac_apply_bf16", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
