"""The Hubbard cylinder's configuration on the CPU: the configuration's
contract, the fermionic reference against an exact diagonalization built
from creation operators, and the cell at a tiny size (width 3, Lx 2,
D 64), correct traced and not, with the checks' faults: a reported energy
altered where the program produces it fails e_report, a solve that hands
back its start fails rel_var."""

import json

import numpy as np
import pytest
import scipy.sparse as sp

from benchmark import run, traffic
from benchmark.reference import fermion_lattice
from conftest import ROOT

HUBBARD = "dmrg-hubbard-yc6x8-D768-f32"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
WIDTH, LX = 3, 2
# a window that finishes a whole solve of the tiny cell on a loaded CPU
SECONDS = 3.0


def _edit(root, rel, change):
    path = root / rel
    data = json.loads(path.read_text())
    change(data)
    path.write_text(json.dumps(data))


@pytest.fixture
def cells_root(tiny_root):
    """The tiny copy with the Hubbard cell cut to WIDTH x LX sites at D=64
    (the full rank of the middle bond)."""
    def cylinder(cfg):
        cfg["lattice"]["width"] = WIDTH
        cfg["program"]["kwargs"]["width"] = WIDTH

    _edit(tiny_root, "benchmark/configs/hubbard_yc6.json", cylinder)
    _edit(tiny_root, f"benchmark/mixes/{HUBBARD}.json",
          lambda m: m.update(L=WIDTH * LX, D=64))
    return tiny_root


def _fails(root, cell, number, seed=7):
    r = run.measure(cell, seed, SECONDS, False, "cpu", root=root)
    limit = traffic.mix(cell, root)["limits"][number]
    return r["correct"] is False and r["checks"][number]["value"] > limit


def test_configuration_contract():
    cfg = traffic.config("hubbard_yc6", ROOT)
    (entry,) = [c for c in SPEC["configs"] if c["name"] == "hubbard_yc6"]
    assert entry["source"] == cfg["source"]
    assert entry["reduced"] == cfg["reduced"] == ["D", "Lx"]
    assert set(cfg["why_reduced"]) == set(cfg["reduced"])
    assert cfg["d"] == 4 and cfg["w"] == 26
    assert cfg["params"] == {"t": 1.0, "U": 8.0, "mu": 4.0}
    assert cfg["params"]["mu"] == cfg["params"]["U"] / 2
    assert cfg["lattice"]["width"] == 6 and cfg["Lx"] == 8
    assert cfg["D"] == 768 and {"mu", "symmetry"} <= set(cfg["assumed"])
    H = traffic.program_hamiltonian(cfg)
    assert H.W.shape == (6, 26, 26, 4, 4)
    mix = traffic.mix(HUBBARD, ROOT)
    assert mix["L"] == 6 * cfg["Lx"] and mix["D"] == cfg["D"]
    assert fermion_lattice.mpo(cfg, mix["L"]).shape[1:] == (26, 26, 4, 4)
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert cells[HUBBARD]["config"] == "hubbard_yc6"
    assert cells[HUBBARD]["chips"] == 1
    (m,) = [m for m in SPEC["per_layer"]
            if m["name"] == "ac_apply_f32_hubbard_roofline"]
    assert m["workloads"] == [HUBBARD] and m["unit"] == "%"


def _exact_hamiltonian(cfg, L):
    """The sparse H on the Fock space of 2 L modes (mode 2 i + s, s = 0
    up, 1 down): c_m = Z x ... x Z x a x 1 x ... x 1, m factors Z."""
    a = sp.csr_matrix([[0.0, 1.0], [0.0, 0.0]])
    Z = sp.csr_matrix(np.diag([1.0, -1.0]))

    def c(m):
        out = sp.identity(1, format="csr")
        for k in range(2 * L):
            out = sp.kron(out, Z if k < m else a if k == m
                          else sp.identity(2), format="csr")
        return out

    p = cfg["params"]
    cs = [c(m) for m in range(2 * L)]
    n = [m.T @ m for m in cs]
    H = sp.csr_matrix((4 ** L, 4 ** L))
    for i, j, t in fermion_lattice.bonds(cfg, L):
        for s in (0, 1):
            hop = cs[2 * i + s].T @ cs[2 * j + s]
            H = H + t * (hop + hop.T)
    for i in range(L):
        up, dn = n[2 * i], n[2 * i + 1]
        H = H + p["U"] * up @ dn - p["mu"] * (up + dn)
    return H


def test_reference_is_the_jordan_wigner_hamiltonian():
    """Width 3, Lx 2: the reference's per-site MPO as a 4096 x 4096
    matrix, and its bond list: 9 bonds, hopping -t."""
    cfg = traffic.config("hubbard_yc6", ROOT)
    cfg["lattice"]["width"] = WIDTH
    L = WIDTH * LX
    bl = fermion_lattice.bonds(cfg, L)
    assert sorted((i, j) for i, j, _ in bl) == [
        (0, 1), (0, 2), (0, 3), (1, 2), (1, 4), (2, 5), (3, 4), (3, 5),
        (4, 5)]
    assert {c for _, _, c in bl} == {-1.0}
    Ws = fermion_lattice.mpo(cfg, L)
    w = Ws.shape[1]
    E = np.zeros((w, 1, 1))
    E[0, 0, 0] = 1.0
    for W in Ws:
        m = E.shape[1]
        E = np.einsum("aST,abst->bSsTt", E, W).reshape(w, 4 * m, 4 * m)
    exact = _exact_hamiltonian(cfg, L).toarray()
    assert np.abs(E[w - 1] - exact).max() <= 1e-12


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(cells_root, trace):
    r = run.measure(HUBBARD, 2 ** 31 + 41, SECONDS, bool(trace), "cpu",
                    root=cells_root)
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == set(traffic.mix(HUBBARD, cells_root)["limits"])
    if not trace:
        assert set(r["metrics"]) == {"setup_s", "sweep_s"}


def test_altered_hubbard_energy_fails(cells_root, monkeypatch):
    import mpskit_tpu_torch as mt

    real = mt.expectation_value
    monkeypatch.setattr(mt, "expectation_value",
                        lambda *a, **k: real(*a, **k) * (1 + 1e-3))
    assert _fails(cells_root, HUBBARD, "e_report")


def test_unchanged_hubbard_state_fails(cells_root, monkeypatch):
    import mpskit_tpu_torch as mt

    real = mt.find_groundstate

    def unchanged(psi, H, alg):
        _, envs, eps = real(psi, H, alg)
        return psi, None, eps

    monkeypatch.setattr(mt, "find_groundstate", unchanged)
    assert _fails(cells_root, HUBBARD, "rel_var")
