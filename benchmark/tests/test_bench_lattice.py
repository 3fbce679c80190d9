"""The lattice cell at a tiny size on the CPU (width 3, Lx 2, D 8): the
kind, the lattice reference and the configuration give a correct run,
traced and not; the reference's per-site MPO is the dense sum over the
configuration's bonds; and a wrong bond coefficient in the program's
Hamiltonian reads over the e_report limit, and a solve that hands back
its start over the rel_var limit."""

import json

import numpy as np
import pytest
import torch

from benchmark import run, traffic
from benchmark.reference import lattice
from benchmark.reference import mps as ref
from conftest import ROOT

CELL = "dmrg-j1j2-yc6x12-D768-f32"
WIDTH, LX, D = 3, 2, 8


@pytest.fixture
def lattice_root(tiny_root):
    """The tiny copy with the lattice cell cut to WIDTH x LX sites at D."""
    entry = traffic.cell(CELL, tiny_root)
    cfg_path = tiny_root / "benchmark" / "configs" / f"{entry['config']}.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["lattice"]["width"] = WIDTH
    cfg["program"]["kwargs"]["width"] = WIDTH
    cfg_path.write_text(json.dumps(cfg))
    mix_path = tiny_root / "benchmark" / "mixes" / f"{entry['traffic']}.json"
    mix = json.loads(mix_path.read_text())
    mix.update(L=WIDTH * LX, D=D)
    mix_path.write_text(json.dumps(mix))
    return tiny_root


def _dense(Ws):
    w = Ws.shape[1]
    E = np.zeros((w, 1, 1))
    E[0, 0, 0] = 1
    for W in Ws:
        n = E.shape[1]
        E = np.einsum("aST,abst->bSsTt", E, W).reshape(w, n * 2, n * 2)
    return E[-1]


def test_reference_mpo_is_the_bond_sum():
    cfg = traffic.config("j1j2_yc6", ROOT)
    cfg["lattice"]["width"] = WIDTH
    L = WIDTH * LX
    ops = ref.site_operators(cfg["site"])

    def at(o, i):
        return np.kron(np.kron(np.eye(2 ** i), o), np.eye(2 ** (L - i - 1)))

    H = np.zeros((2 ** L, 2 ** L), complex)
    for i, j, c in lattice.bonds(cfg, L):
        for o in ("Sx", "Sy", "Sz"):
            H += c * at(ops[o], i) @ at(ops[o], j)
    Ws = lattice.mpo(cfg, L, ref.site_operators(cfg["site"]))
    assert Ws.shape[1] == 2 + 3 * (2 * WIDTH - 1)
    assert np.abs(_dense(Ws) - H).max() <= 1e-12


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(lattice_root, trace):
    r = run.measure(CELL, 2 ** 31 + 13, 1.5, bool(trace), "cpu",
                    root=lattice_root)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1
    assert set(r["checks"]) == {"e_report", "rel_var"}
    if not trace:
        assert set(r["metrics"]) == {"setup_s", "sweep_s"}


def test_wrong_bond_coefficient_fails(lattice_root, monkeypatch):
    """The (1, -1) diagonals counted twice: J2 doubled on half the
    next-nearest bonds."""
    from mpskit_tpu_torch.models import lattices

    monkeypatch.setattr(lattices, "SQUARE_J2",
                        lattices.SQUARE_J2 + ((1, -1),))
    r = run.measure(CELL, 7, 1.0, False, "cpu", root=lattice_root)
    mix = traffic.mix(CELL, lattice_root)
    assert r["correct"] is False
    assert r["checks"]["e_report"]["value"] > mix["limits"]["e_report"]


def test_unchanged_state_fails(lattice_root, monkeypatch):
    import mpskit_tpu_torch as mt

    real = mt.find_groundstate

    def unchanged(psi, H, alg):
        _, envs, eps = real(psi, H, alg)
        return psi, None, eps

    monkeypatch.setattr(mt, "find_groundstate", unchanged)
    r = run.measure(CELL, 7, 1.0, False, "cpu", root=lattice_root)
    mix = traffic.mix(CELL, lattice_root)
    assert r["correct"] is False
    assert r["checks"]["rel_var"]["value"] > mix["limits"]["rel_var"]


def test_variance_of_an_eigenstate_vanishes():
    """The blocked H^2 environments: an eigenvector of the dense H, cut
    into an exact MPS, has variance zero; a random state does not."""
    cfg = traffic.config("j1j2_yc6", ROOT)
    cfg["lattice"]["width"] = WIDTH
    L = WIDTH * LX
    Wn = lattice.mpo(cfg, L, ref.site_operators(cfg["site"]))
    Ws = torch.as_tensor(Wn)
    vals, vecs = np.linalg.eigh(_dense(Wn))

    def mps(v):
        As, rest = [], torch.as_tensor(v).reshape(1, -1)
        for _ in range(L - 1):
            Dl = rest.shape[0]
            U, S, Vh = torch.linalg.svd(rest.reshape(Dl * 2, -1),
                                        full_matrices=False)
            As.append(U.reshape(Dl, 2, -1))
            rest = S[:, None] * Vh
        return As + [rest.reshape(rest.shape[0], 2, 1)]

    ground = mps(vecs[:, 0])
    assert abs(lattice.energy(ground, Ws) - vals[0]) <= 1e-10
    assert abs(lattice.variance(ground, Ws, block_bytes=1)) <= 1e-10
    rand = mps(np.random.default_rng(0).standard_normal(2 ** L))
    assert lattice.variance(rand, Ws, block_bytes=1) > 1e-2
