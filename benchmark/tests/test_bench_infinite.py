"""The infinite-cylinder cell at a tiny size on the CPU (width 4, D 8): the
kind, the infinite reference and the configuration give a correct run,
traced and not, and the traced run reads both of the cell's own metrics
from its recorded unit; a reported energy altered where the program
produces it, a wrong bond coefficient in the program's Hamiltonian and a
returned state paired with another state's environments each read over
the e_report limit; iterations that hand back their input, and
eigensolves whose answers are dropped, read over the e_rise limit though
their environments are their own; and a returned cell that is no
isometry reads over the iso_err limit."""

import dataclasses
import json

import pytest

from benchmark import run, traffic

CELL = "vumps-j1j2-yc6inf-D768-f32"
WIDTH, D = 4, 8


@pytest.fixture
def infinite_root(tiny_root):
    """The tiny copy with the infinite cell cut to a WIDTH-site cell at D,
    2 warm iterations and 2-iteration solves."""
    entry = traffic.cell(CELL, tiny_root)
    cfg_path = tiny_root / "benchmark" / "configs" / f"{entry['config']}.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["lattice"]["width"] = WIDTH
    cfg["program"]["kwargs"]["width"] = WIDTH
    cfg_path.write_text(json.dumps(cfg))
    mix_path = tiny_root / "benchmark" / "mixes" / f"{entry['traffic']}.json"
    mix = json.loads(mix_path.read_text())
    mix.update(D=D, warm_iterations=2, iterations_per_solve=2)
    mix_path.write_text(json.dumps(mix))
    return tiny_root


def _fails(root, number="e_report", seed=7):
    r = run.measure(CELL, seed, 1.0, False, "cpu", root=root)
    limit = traffic.mix(CELL, root)["limits"][number]
    return r["correct"] is False and r["checks"][number]["value"] > limit


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(infinite_root, trace):
    r = run.measure(CELL, 2 ** 31 + 29, 1.5, bool(trace), "cpu",
                    root=infinite_root)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1
    assert set(r["checks"]) == {"e_report", "e_rise", "iso_err"}
    if trace:
        m = r["metrics"]
        assert 0 < m["envs_span_pct.sweep"]["value"] < 100
        assert m["gmres_matvecs.sweep"]["value"] >= 1
        assert m["matvecs.sweep"]["value"] >= 2 * WIDTH
    else:
        assert set(r["metrics"]) == {"setup_s", "sweep_s"}


def test_altered_energy_fails(infinite_root, monkeypatch):
    import mpskit_tpu_torch as mt

    real = mt.find_groundstate

    def altered(psi, H, alg):
        out, envs, eps = real(psi, H, alg)
        return out, dataclasses.replace(
            envs, e_density=envs.e_density * (1 + 1e-3)), eps

    monkeypatch.setattr(mt, "find_groundstate", altered)
    assert _fails(infinite_root)


def test_wrong_bond_coefficient_fails(infinite_root, monkeypatch):
    """The (1, -1) diagonals counted twice: J2 doubled on half the
    next-nearest bonds."""
    from mpskit_tpu_torch.models import lattices

    monkeypatch.setattr(lattices, "SQUARE_J2",
                        lattices.SQUARE_J2 + ((1, -1),))
    assert _fails(infinite_root)


def test_state_paired_with_other_envs_fails(infinite_root, monkeypatch):
    """Each solve hands back its start state with the environments of the
    state it reached."""
    import mpskit_tpu_torch as mt

    real = mt.find_groundstate

    def unchanged(psi, H, alg):
        _, envs, eps = real(psi, H, alg)
        return psi, envs, eps

    monkeypatch.setattr(mt, "find_groundstate", unchanged)
    assert _fails(infinite_root)


def _input_returned(monkeypatch):
    """Every VUMPS iteration hands back the state it was given (with the
    walk and the eigensolves run): the solve's final environments are
    then computed from its start."""
    from mpskit_tpu_torch.algorithms import vumps

    real = vumps._vumps_iteration_impl

    def idle(psi, H, *args, **kwargs):
        _, eps, envs, diag = real(psi, H, *args, **kwargs)
        return psi, eps, envs, diag

    monkeypatch.setattr(vumps, "_vumps_iteration_impl", idle)


def _answers_dropped(monkeypatch):
    """Every AC and C eigensolve returns its start vector, so the
    regauge rebuilds the state it started from."""
    from mpskit_tpu_torch.algorithms import vumps

    real = vumps.eigsh_smallest

    def dropped(matvec, v0, *args, **kwargs):
        return real(matvec, v0, *args, **kwargs)._replace(eigenvector=v0)

    monkeypatch.setattr(vumps, "eigsh_smallest", dropped)


@pytest.mark.parametrize("plant", [_input_returned, _answers_dropped])
def test_solves_that_return_their_start_fail(infinite_root, monkeypatch,
                                             plant):
    """The state stands still while its reported energy, environments
    and isometries stay consistent: only e_rise sees it."""
    plant(monkeypatch)
    r = run.measure(CELL, 7, 1.0, False, "cpu", root=infinite_root)
    limits = traffic.mix(CELL, infinite_root)["limits"]
    values = {k: c["value"] for k, c in r["checks"].items()}
    assert r["correct"] is False
    assert values["e_rise"] > limits["e_rise"], values
    assert values["e_report"] <= limits["e_report"], values
    assert values["iso_err"] <= limits["iso_err"], values


def test_cell_off_the_isometries_fails(infinite_root, monkeypatch):
    """The returned AL scaled by 1 + 1e-3: the same state, so its energy
    reads right, but no longer left-isometric."""
    import mpskit_tpu_torch as mt

    real = mt.find_groundstate

    def scaled(psi, H, alg):
        out, envs, eps = real(psi, H, alg)
        return dataclasses.replace(out, AL=out.AL * (1 + 1e-3)), envs, eps

    monkeypatch.setattr(mt, "find_groundstate", scaled)
    assert _fails(infinite_root, "iso_err")
