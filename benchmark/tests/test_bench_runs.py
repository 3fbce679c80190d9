"""Whole runs of every cell at tiny sizes on the CPU, through the
harness's own set-up, window, trace and check (the chip's look is the
only part left out)."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import run, traffic
from conftest import CELLS, ROOT

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "checks"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(tiny_root, name, trace):
    r = run.measure(name, 2 ** 31 + 11, 1.5, bool(trace), "cpu",
                    root=tiny_root)
    assert list(r) == RESULT_KEYS
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    mix = traffic.mix(traffic.cell(name, tiny_root)["traffic"], tiny_root)
    assert set(r["checks"]) == set(mix["limits"])
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = traffic.cell(name, ROOT)
    if trace:
        names = {m["name"] for m in run.cell_metrics(spec, entry,
                                                     "per_layer")}
        # on the CPU the readers of the card's trace, probe and peak
        # find nothing to read; the counters and the split do
        assert set(r["metrics"]) <= names
        assert any(k.startswith("host_syncs.") for k in r["metrics"])
    else:
        names = {m["name"] for m in run.cell_metrics(spec, entry,
                                                     "end_to_end")}
        assert set(r["metrics"]) == names
        assert "setup_s" in names and len(names) >= 2
    for m in r["metrics"].values():
        assert m["value"] > 0
    assert r["device"]["count"] == entry["chips"]


@pytest.mark.parametrize("name", CELLS)
def test_seed_fixes_the_inputs(tiny_root, name):
    """The same seed gives the same first answer; another seed another
    (the quench's start, a converged ground state, differs only by
    rounding, so its first step is compared)."""
    entry = traffic.cell(name, tiny_root)
    cfg = traffic.config(entry["config"], tiny_root)
    mix = traffic.mix(entry["traffic"], tiny_root)

    def first(seed):
        wl = traffic.workload(cfg, mix, seed, "cpu", tiny_root)
        wl.work(lambda: None)
        out = wl.states[-1].AC if name.startswith("tdvp") else \
            wl.outputs[0][0]
        return out.AC if hasattr(out, "AC") else out

    a, b, c = first(2 ** 31 + 5), first(2 ** 31 + 5), first(2 ** 31 + 6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def _python(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints nothing on
    standard output."""
    p = _python(["benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
                 "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_bare_benchmark_fails(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/ has no program:
    the run exits non-zero and prints nothing."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _python(["benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
                 "--seconds", "1", "--trace", "0"], tmp_path, env)
    assert p.returncode != 0 and p.stdout == ""


def test_run_loads_no_jax(tiny_root):
    """A whole run loads no module whose top-level name is jax, jaxlib,
    flax or the JAX package (compared whole: mpskit_tpu_torch is not
    mpskit_tpu)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import run\n"
        "from pathlib import Path\n"
        "r = run.measure(%r, 3, 1.5, True, 'cpu', root=Path(%r))\n"
        "assert r['correct']\n"
        "assert 'mpskit_tpu_torch' in sys.modules\n"
        "print(run.forbidden_modules())\n"
    ) % (str(ROOT), CELLS[0], str(tiny_root))
    # one thread, as the tests in this process run
    p = _python(["-c", code], ROOT, {**os.environ, "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
