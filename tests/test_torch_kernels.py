"""Kernel layer of the PyTorch port against the JAX package.

- The plain version of K1 (`ac_apply_bf16_reference`) against the Pallas
  kernel `scripts/exp_r5_bf16_matvec.py::_kernel` itself, run in Pallas
  interpret mode on the CPU. The kernel and its launcher are taken from the
  script's syntax tree, so the script's top level (a D=512 timing loop) does
  not run; `pallas_call` gets `interpret=True`, the BlockSpecs are the
  script's own.
- The exact matvecs `ac_apply` / `c_apply` against the JAX versions.
The card-only checks of K1 are in test_torch_cuda.py.
"""

import ast
import functools
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mpskit_tpu.algorithms import derivatives as jder
from mpskit_tpu_torch.algorithms import derivatives as tder
from mpskit_tpu_torch.config import matmul_precision
from mpskit_tpu_torch.kernels import ac_apply as k1

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "exp_r5_bf16_matvec.py"


def _script_pallas_fast(D: int, d: int, w: int):
    """`pallas_fast` of the script at shape (D, d, w), in interpret mode."""
    tree = ast.parse(SCRIPT.read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef)
                and n.name in ("_kernel", "pallas_fast"))
            or (isinstance(n, ast.Assign)
                and ast.unparse(n.targets[0]) == "TX")]
    assert len(keep) == 3, "the script's kernel, launcher or TX moved"
    interp = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    ns = {"jax": jax, "jnp": jnp, "pl": interp, "pltpu": pltpu,
          "D": D, "d": d, "w": w}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(SCRIPT), "exec"),
         ns)
    return ns["pallas_fast"]


def _k1_inputs(D, d, w, seed):
    rng = np.random.default_rng(seed)
    GL = (rng.standard_normal((w, D, D)) / D).astype(np.float32)
    GR = (rng.standard_normal((w, D, D)) / D).astype(np.float32)
    W = rng.standard_normal((w, w, d, d)).astype(np.float32)
    x = rng.standard_normal((D, d, D)).astype(np.float32)
    return GL, W, GR, x


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("D", [128, 256])
def test_k1_plain_matches_pallas_kernel(D):
    """Same rounding points as the TPU kernel: the two differ only in the
    order of f32 sums and in rare 1-ulp bf16 roundings of t2 that order
    flips, ~1e-5 relative; 1e-4 is the bound."""
    d, w = 2, 3
    GL, W, GR, x = _k1_inputs(D, d, w, seed=D)
    y_pallas = np.asarray(_script_pallas_fast(D, d, w)(GL, W, W, GR, x))
    with matmul_precision():
        y_plain = k1.ac_apply_bf16_reference(
            *(torch.from_numpy(a) for a in (GL, W, GR, x))).numpy()
    assert _rel(y_plain, y_pallas) <= 1e-4
    # and both sit within bf16 noise of the exact matvec
    y_exact = np.asarray(jder.ac_apply(*(a.astype(np.float64)
                                         for a in (GL, W, GR, x))))
    assert _rel(y_plain, y_exact) <= 1e-2


def test_k1_wrapper_uses_plain_version_on_cpu():
    GL, W, GR, x = (torch.from_numpy(a) for a in _k1_inputs(40, 2, 3, 0))
    before = k1.launches
    y = k1.ac_apply_bf16(GL, W, GR, x)
    assert k1.launches == before
    torch.testing.assert_close(y, k1.ac_apply_bf16_reference(GL, W, GR, x),
                               rtol=0, atol=0)
    # on the CPU the fast matvec is the exact one, as in the JAX package
    torch.testing.assert_close(tder.ac_apply_fast(GL, W, GR, x),
                               tder.ac_apply(GL, W, GR, x), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_ac_apply_and_c_apply_match_jax(dtype):
    rng = np.random.default_rng(7)
    D, d, w = 12, 3, 4

    def rand(*shape):
        a = rng.standard_normal(shape)
        if np.issubdtype(dtype, np.complexfloating):
            a = a + 1j * rng.standard_normal(shape)
        return a.astype(dtype)

    GL, GR, W, x, c = (rand(w, D, D), rand(w, D, D), rand(w, w, d, d),
                       rand(D, d, D), rand(D, D))
    t = [torch.from_numpy(a) for a in (GL, W, GR, x)]
    np.testing.assert_allclose(tder.ac_apply(*t).numpy(),
                               np.asarray(jder.ac_apply(GL, W, GR, x)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tder.c_apply(torch.from_numpy(GL), torch.from_numpy(GR),
                     torch.from_numpy(c)).numpy(),
        np.asarray(jder.c_apply(GL, GR, c)), rtol=1e-12, atol=1e-12)


def test_chip_smoke_refuses_without_a_card():
    """chip_smoke.py exits non-zero and prints no result without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
