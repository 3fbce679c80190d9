"""The check fails a run whose timed path is broken underneath: a solve
or step that hands back its state unchanged, and an answer altered where
the program produces it. (One chip, no batch: the other faults cannot
happen in these cells.)"""

import pytest
import torch

import mpskit_tpu_torch as mt
from benchmark import run
from conftest import CELLS

GROUND = [c for c in CELLS if not c.startswith("tdvp")]
QUENCH = [c for c in CELLS if c.startswith("tdvp")]


REAL_SOLVE, REAL_STEP = mt.find_groundstate, mt.timestep


def _unchanged_solve(psi, H, alg):
    """The solve's work done, its start handed back."""
    _, envs, eps = REAL_SOLVE(psi, H, alg)
    return psi, None, eps


def _unchanged_step(psi, H, t, dt, alg):
    """The step's work done, its start handed back."""
    REAL_STEP(psi, H, t, dt, alg)
    return psi, None


def _measure(name, root):
    return run.measure(name, 5, 1.0, False, "cpu", root=root)


@pytest.mark.parametrize("name", GROUND)
def test_unchanged_state_fails(tiny_root, monkeypatch, name):
    monkeypatch.setattr(mt, "find_groundstate", _unchanged_solve)
    assert _measure(name, tiny_root)["correct"] is False


@pytest.mark.parametrize("name", GROUND)
def test_altered_energy_fails(tiny_root, monkeypatch, name):
    real = mt.expectation_value
    monkeypatch.setattr(mt, "expectation_value",
                        lambda *a, **k: real(*a, **k) * (1 + 1e-3))
    assert _measure(name, tiny_root)["correct"] is False


@pytest.mark.parametrize("name", QUENCH)
def test_unchanged_step_fails(tiny_root, monkeypatch, name):
    monkeypatch.setattr(mt, "timestep", _unchanged_step)
    assert _measure(name, tiny_root)["correct"] is False


@pytest.mark.parametrize("name", QUENCH)
def test_altered_state_fails(tiny_root, monkeypatch, name):
    def altered(psi, H, t, dt, alg):
        out, envs = REAL_STEP(psi, H, t, dt, alg)
        mid = out.ARs.shape[0] // 2
        ARs = out.ARs.clone()
        ARs[mid] = ARs[mid] * (1 + 1e-2 * torch.randn(
            ARs[mid].shape, generator=torch.Generator().manual_seed(0)))
        return mt.FiniteMPS(out.ALs, ARs, out.AC, out.center), envs

    monkeypatch.setattr(mt, "timestep", altered)
    assert _measure(name, tiny_root)["correct"] is False
