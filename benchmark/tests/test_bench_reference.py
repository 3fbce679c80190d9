"""The plain reference against the program in float64 at small sizes
(energies, variances, one TDVP step), and against
dense matrices and closed forms; and the reference imports nothing of
the program."""

import ast
import subprocess
import sys

import numpy as np
import pytest
import scipy.linalg
import torch

import mpskit_tpu_torch as mt
from benchmark import traffic
from benchmark.kinds import shared
from benchmark.reference import exact_tfim
from benchmark.reference import mps as ref
from conftest import ROOT

TFIM = traffic.config("tfim")
HEIS = traffic.config("heisenberg_s1")


def _dense(W, L):
    w = W.shape[0]
    M = W[0]
    for _ in range(1, L):
        M = np.einsum("bst,bcuv->csutv", M, W).reshape(
            w, M.shape[1] * W.shape[2], M.shape[2] * W.shape[3])
    return M[w - 1]


def _vector(As):
    v = As[0]
    for A in As[1:]:
        v = torch.einsum("...a,asb->...sb", v, A)
    return v.reshape(-1).numpy()


def _random_state(L, d, D, dtype, seed):
    return mt.FiniteMPS.random(L, d, D, dtype, "cpu",
                               torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("cfg, L", [(TFIM, 7), (HEIS, 5)])
def test_energy_and_variance_match_dense(cfg, L):
    W = ref.mpo(cfg)
    psi = _random_state(L, cfg["d"], 64, torch.float64, 1)
    As, Wt = ref.as_reference(ref.trimmed(shared.site_tensors(psi), 64), W,
                              "cpu")
    v, H = _vector(As), _dense(W, L)
    e = v @ H @ v / (v @ v)
    assert ref.energy(As, Wt) == pytest.approx(e, rel=1e-12)
    var = v @ H @ H @ v / (v @ v) - e ** 2
    assert ref.variance(As, Wt) == pytest.approx(var, rel=1e-10)
    assert ref.mpo(cfg).shape[0] == cfg["w"]


@pytest.mark.parametrize("cfg, L, D", [(TFIM, 10, 12), (HEIS, 8, 20)])
def test_energy_matches_program(cfg, L, D):
    H = traffic.program_hamiltonian(cfg)
    psi = _random_state(L, cfg["d"], D, torch.float64, 2)
    psi, envs, _ = mt.find_groundstate(psi, H, mt.DMRG(maxiter=6,
                                                       verbosity=0))
    e_prog = float(mt.expectation_value(psi, H, envs=envs))
    As, Wt = ref.as_reference(ref.trimmed(shared.site_tensors(psi), D),
                              ref.mpo(cfg), "cpu")
    assert ref.energy(As, Wt) == pytest.approx(e_prog, rel=1e-12)
    if cfg is TFIM:
        assert e_prog == pytest.approx(
            exact_tfim.open_chain_e0(L, cfg["params"]), rel=1e-9)


def test_tdvp_step_matches_program_and_exact():
    L, D, dt = 8, 6, 0.05
    H1 = traffic.program_hamiltonian(TFIM, {"g": 0.5})
    psi = _random_state(L, 2, D, torch.complex128, 4)
    out, _ = mt.timestep(psi, H1, 0.0, dt, mt.TDVP(expalg_m=30))
    W1 = ref.mpo(TFIM, {"g": 0.5})
    As, Wt = ref.as_reference(ref.trimmed(shared.site_tensors(psi), D), W1,
                              "cpu")
    Bs = ref.as_reference(ref.trimmed(shared.site_tensors(out), D), W1,
                          "cpu")[0]
    assert 1 - ref.fidelity(Bs, ref.tdvp_step(As, Wt, dt)) < 1e-12
    # at full rank one-site TDVP is the exact evolution
    full = _random_state(6, 2, 8, torch.complex128, 5)
    Fs, Wt = ref.as_reference(ref.trimmed(shared.site_tensors(full), 8), W1,
                              "cpu")
    exact = scipy.linalg.expm(-1j * dt * _dense(W1, 6)) @ _vector(Fs)
    step = _vector(ref.tdvp_step(Fs, Wt, dt))
    assert abs(np.vdot(step, exact)) / (np.linalg.norm(step)
                                        * np.linalg.norm(exact)) \
        == pytest.approx(1, abs=1e-13)


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "numpy", "torch"}
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            assert {m.split(".")[0] for m in mods} <= allowed, (path, mods)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.mps, benchmark.reference.exact_tfim\n"
            "print(sorted(m for m in sys.modules if m.startswith("
            "'mpskit_tpu')))") % str(ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stderr
