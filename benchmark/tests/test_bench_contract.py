"""BENCHMARK.json against the benchmark's contract (keys, names, units,
sources, bounds, the run length's budget, each cell's metrics), the files
the harness finds by name, and a mix and a metric dropped into a copy of
the benchmark and found there without an edit."""

import json
import re
import types

import pytest

from benchmark import run
from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert all(_line(w) for w in SPEC["command"])


def test_run_length_fits_a_full_check():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.fullmatch(entry["name"]), entry["name"]
            names.append(entry["name"])
    assert len(names) == len(set(names))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.fullmatch(w["traffic"]) and NAME.fullmatch(w["config"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
        assert m["source"] in SOURCES
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    used = set()
    for w in SPEC["workloads"]:
        used.add(w["config"])
        e2e = run.cell_metrics(SPEC, w, "end_to_end")
        assert {m["name"] for m in e2e} >= {"setup_s"} and len(e2e) >= 2
        layer = run.cell_metrics(SPEC, w, "per_layer")
        assert layer
        moved = {m["name"] for m in e2e}
        assert all(m["moves"] in moved for m in layer)
    assert used == {c["name"] for c in SPEC["configs"]}


def test_files_found_by_name():
    files = {c["file"] for c in SPEC["configs"]}
    assert len(files) == len(SPEC["configs"])
    for c in SPEC["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        mix = json.loads((ROOT / "benchmark" / "mixes"
                          / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "kinds" / f"{mix['kind']}.py").exists()
        assert mix["limits"]
    for m in SPEC["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()


def test_file_names_use_name_characters():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert PATH.fullmatch(rel), rel
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_dropped_in_mix_and_metric_are_found(tiny_root):
    """A later cell and per-layer metric arrive as files and entries."""
    mixes = tiny_root / "benchmark" / "mixes"
    base = json.loads((mixes / "dmrg-tfim-L32-D512-f32.json").read_text())
    base["solver"]["maxiter"] = 2
    (mixes / "dmrg-tfim-L8-later.json").write_text(json.dumps(base))
    (tiny_root / "benchmark" / "metrics" / "units_seen.sweep.py").write_text(
        "def read(rec):\n    return float(rec.units)\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "dmrg-tfim-later", "config": "tfim",
                              "traffic": "dmrg-tfim-L8-later", "chips": 1,
                              "why": "a later cell"})
    spec["per_layer"].append({"name": "units_seen.sweep", "unit": "sweeps",
                              "better": "higher", "source": "host_clock",
                              "layer": "algorithm driver",
                              "moves": "sweep_s",
                              "workloads": ["dmrg-tfim-later"]})
    for m in spec["end_to_end"]:
        if m["name"] == "sweep_s":
            m["workloads"].append("dmrg-tfim-later")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run.measure("dmrg-tfim-later", 9, 0.5, True, "cpu", root=tiny_root)
    assert r["correct"]
    assert set(r["metrics"]) == {"units_seen.sweep"}
    assert r["metrics"]["units_seen.sweep"]["value"] >= 1
    r = run.measure("dmrg-tfim-later", 9, 0.5, False, "cpu", root=tiny_root)
    assert set(r["metrics"]) == {"setup_s", "sweep_s"}


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["per_layer"]])
def test_reader_finds_nothing_without_its_input(name):
    """Every reader returns nothing for a record that holds nothing for
    it (a cell of another unit, no trace, no probe)."""
    from benchmark import traffic

    mod = traffic.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                              f"_metric_{name}")
    rec = types.SimpleNamespace(unit="none", units=1, window_s=1.0, syncs=0,
                     counts={}, split=None, profile=None, probes={},
                     device="cpu")
    assert mod.read(rec) is None
