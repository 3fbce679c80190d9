"""The J1-J2 Heisenberg model on an infinite square cylinder: the port's
infinite path (`hamiltonian_environments`, VUMPS) under `j1_j2_model`,
held on the CPU in float64 to the benchmark's plain reference
(benchmark/reference/infinite_lattice.py), which reads the energy per
site of a one-column unit cell from the transfer operator's fixed points
and the configuration's bond list, trusting no gauge. And how the
walk uses the MPO's structure: one GMRES solve per walk, whose operator
applications a recording counts."""

import json
import sys
from pathlib import Path

import pytest
import torch

from mpskit_tpu_torch import VUMPS, InfiniteMPS, find_groundstate, j1_j2_model
from mpskit_tpu_torch.environments import infinite_ham
from mpskit_tpu_torch.environments.infinite_ham import (
    hamiltonian_environments,
)
from mpskit_tpu_torch.operators.mpo import DIAG_IDENTITY, DIAG_ZERO
from mpskit_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import infinite_lattice, lattice  # noqa: E402
from benchmark.reference import mps as ref  # noqa: E402

J1, J2 = 1.0, 0.5


def _cfg(width):
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "j1j2_yc6_inf.json").read_text())
    cfg["lattice"]["width"] = width
    return cfg


def _reference_energy(As, width):
    cfg = _cfg(width)
    return infinite_lattice.energy(list(As), lattice.bonds(cfg, 2 * width),
                                   cfg["pair"],
                                   ref.site_operators(cfg["site"]))


def _random_state(width, D, seed):
    gen = torch.Generator().manual_seed(seed)
    return InfiniteMPS.random(width, 2, D, torch.float64, "cpu", gen)


@pytest.mark.parametrize("width,D", [(4, 16), (6, 8)])
def test_environment_energy_equals_the_reference(width, D):
    """The walk's energy per site of a seeded random one-column state
    equals the reference's, read from the AL cell and from the AR cell
    (the same state in another gauge)."""
    psi = _random_state(width, D, 30 + width)
    e = float(hamiltonian_environments(psi, j1_j2_model(J1, J2,
                                                        width=width)
                                       ).e_density)
    for As in (psi.AL, psi.AR):
        e_ref = _reference_energy(As, width)
        assert abs(e_ref) > 1e-3
        assert abs(e - e_ref) <= 1e-12 * max(1.0, abs(e_ref))


def test_vumps_reports_the_reference_energy_of_its_state():
    """Three VUMPS iterations at width 4, D 16: the returned environments'
    energy is the reference's energy of the returned AL cell, and below
    the random start's."""
    width = 4
    psi0 = _random_state(width, 16, 41)
    H = j1_j2_model(J1, J2, width=width)
    psi, envs, _ = find_groundstate(
        psi0, H, VUMPS(krylovdim=10, eig_maxrestarts=2, tol=0.0, maxiter=3,
                       verbosity=0))
    e_ref = _reference_energy(psi.AL, width)
    assert abs(float(envs.e_density) - e_ref) <= 1e-10 * abs(e_ref)
    assert e_ref < _reference_energy(psi0.AL, width) - 0.1


@pytest.mark.parametrize("width", [4, 6])
def test_walk_solves_only_the_identity_levels(width, monkeypatch):
    """Levels 0 and w-1 the identity and every middle level's diagonal
    zero over the period (with W upper-triangular, which
    test_torch_j1j2.py::test_middle_channels_vanish_over_the_period
    checks at widths 3-8): the walk then solves one GMRES problem, the
    paired identity level, and sums every other level in one pass."""
    H = j1_j2_model(J1, J2, width=width)
    w = H.odim
    assert H.diag_class[0] == H.diag_class[w - 1] == DIAG_IDENTITY
    assert set(H.diag_class[1:w - 1]) == {DIAG_ZERO}
    applied = [0]
    real = infinite_ham.linsolve_info

    def counted(matvec, b, *args, **kwargs):
        def mv(x):
            applied[0] += 1
            return matvec(x)
        return real(mv, b, *args, **kwargs)

    monkeypatch.setattr(infinite_ham, "linsolve_info", counted)
    with trace.recording() as rec:
        hamiltonian_environments(_random_state(width, 8, 50 + width), H)
    assert rec.counts["envs"] == 1 and rec.counts["gmres"] == 1
    assert rec.counts["gmres_op"] == applied[0] > 0
