"""Global defaults, verbosity levels, the float32 precision policy and the
device-mesh configuration (counterpart of mpskit_tpu/config.py)."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

VERBOSE_NONE = 0
VERBOSE_WARN = 1
VERBOSE_CONV = 2
VERBOSE_ITER = 3
VERBOSE_ALL = 4


class Defaults:
    """Numeric and solver defaults (same values as mpskit_tpu.config)."""

    eltype = torch.complex128
    real_eltype = torch.float64

    maxiter: int = 100
    miniter: int = 5
    tol: float = 1e-12
    tolgauge: float = 1e-13
    verbosity: int = VERBOSE_WARN

    krylovdim: int = 30
    eig_maxiter: int = 100
    linsolve_maxiter: int = 60
    gauge_maxiter: int = 500

    tol_factor: float = 1e-4
    tol_min: float = 1e-14
    tol_max: float = 1e-4
    eig_miniter: int = 10


@contextlib.contextmanager
def matmul_precision():
    """Pin exact float32 matmuls for the hot sweeps.

    The JAX package pins BF16_BF16_F32_X3 on the TPU because the TPU's
    default float32 matmul is one-pass bf16. The card's counterpart of that
    inexact default is TF32, so every exact path runs with TF32 off for
    cuBLAS and cuDNN. Only `ac_apply_fast` is inexact, on purpose, and it
    does not go through these flags."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh configuration for sharded contractions (counterpart of
    mpskit_tpu.config.MeshConfig): a `torch.distributed` DeviceMesh of
    `parallel.mesh.make_mesh` and the names of its axes over which the
    virtual (bond) dimension and the unit-cell / site axis are sharded."""

    mesh: Optional["torch.distributed.device_mesh.DeviceMesh"] = None
    bond_axis: Optional[str] = "bond"
    site_axis: Optional[str] = None

    @staticmethod
    def single_device() -> "MeshConfig":
        return MeshConfig(mesh=None)


_GLOBAL_MESH: MeshConfig = MeshConfig.single_device()


def set_mesh(cfg: MeshConfig) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = cfg


def get_mesh() -> MeshConfig:
    return _GLOBAL_MESH
