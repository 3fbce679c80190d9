"""The span metrics (benchmark/program_trace.py and the readers of the
program's spans): the idle assignment on intervals made up by hand, and
tiny traced runs on the CPU."""

import json
import sys
import types

import pytest

from benchmark import program_trace, run, traffic
from conftest import ROOT, tiny_copy

from mpskit_tpu_torch.utils.trace import Span

NEW = ["eigensolve_span_pct.sweep", "expm_span_pct.step",
       "svd_span_pct.sweep", "sync_wait_pct.sweep", "sync_wait_pct.step",
       "idle_in_krylov_pct.sweep", "idle_in_krylov_pct.step",
       "matvecs.sweep", "matvecs.step"]
MS = 1_000_000  # ns


def test_idle_goes_to_the_innermost_span_at_its_middle():
    """A unit [0, 200] ms: sweep [10, 150] holds eigsh [20, 80] (which
    holds matvec [30, 40]) and qr [90, 100]; the device is busy in
    [5, 25], [37, 60], [85, 95], [110, 160] and [175, 190]."""
    spans = [Span("matvec", 2, 1, 30 * MS, 40 * MS, "exact"),
             Span("eigsh", 1, 0, 20 * MS, 80 * MS),
             Span("qr", 3, 0, 90 * MS, 100 * MS),
             Span("sweep", 0, None, 10 * MS, 150 * MS)]
    busy = [(a * MS, b * MS) for a, b in
            [(5, 25), (37, 60), (85, 95), (110, 160), (175, 190)]]
    idle, krylov = program_trace.assign_idle(spans, 0, 200 * MS, busy)
    # the gaps [0, 5] and [190, 200] at the unit's edges and [160, 175]
    # after the sweep are in no span; [25, 37] in the matvec, [60, 85] in
    # eigsh itself, [95, 110] in the sweep once qr has closed
    assert idle == pytest.approx({program_trace.NO_SPAN: 0.030,
                                  "matvec": 0.012, "eigsh": 0.025,
                                  "sweep": 0.015})
    assert krylov == pytest.approx(0.037)


def test_busy_edges_outside_the_unit_are_cut():
    spans = [Span("expm", 0, None, 0, 100 * MS)]
    idle, krylov = program_trace.assign_idle(
        spans, 10 * MS, 90 * MS, [(0, 20 * MS), (80 * MS, 120 * MS)])
    assert idle == pytest.approx({"expm": 0.060})
    assert krylov == pytest.approx(0.060)
    idle, krylov = program_trace.assign_idle([], 0, 10 * MS, [])
    assert idle == pytest.approx({program_trace.NO_SPAN: 0.010})
    assert krylov == 0


def test_innermost_follows_the_nesting():
    spans = [Span("b", 1, 0, 2, 4), Span("c", 2, 0, 4, 6),
             Span("a", 0, None, 1, 9)]
    times, owners = program_trace.innermost(spans)
    names = [None if o is None else o.name for o in owners]
    assert times == [1, 2, 4, 4, 6, 9]
    assert names == ["a", "b", "a", "c", "a", None]


def test_no_spans_in_the_program_reads_nothing(monkeypatch):
    """A program without utils/trace.py (an older one) gives no record,
    and the stretch does not run."""
    import mpskit_tpu_torch.utils

    monkeypatch.delattr(mpskit_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "mpskit_tpu_torch.utils.trace", None)
    rec = types.SimpleNamespace(unit="sweep", device="cpu")
    assert program_trace.unit_spans(rec) is None


def _without_new(root):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"] = [m for m in spec["per_layer"]
                         if m["name"] not in NEW]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_traced_dmrg_reports_the_span_metrics(tiny_root, tmp_path_factory):
    name = "dmrg-tfim-L32-D512-f32"
    r = run.measure(name, 2 ** 31 + 21, 1.0, True, "cpu", root=tiny_root)
    assert r["correct"]
    m = r["metrics"]
    for k in ("eigensolve_span_pct.sweep", "sync_wait_pct.sweep",
              "matvecs.sweep"):
        assert isinstance(m[k]["value"], (int, float)) and m[k]["value"] > 0
    assert 0 < m["sync_wait_pct.sweep"]["value"] < m[
        "eigensolve_span_pct.sweep"]["value"] < 100
    assert "idle_in_krylov_pct.sweep" not in m
    # the metrics that were there before keep their keys
    old = tiny_copy(tmp_path_factory.mktemp("old"))
    _without_new(old)
    r0 = run.measure(name, 2 ** 31 + 21, 1.0, True, "cpu", root=old)
    assert set(r0["metrics"]) == {k for k in m if k not in NEW}
    assert {"host_syncs.sweep", "eigensolve_pct.sweep"} <= set(r0["metrics"])


def test_traced_quench_counts_m_matvecs_per_exponential(tiny_root):
    name = "tdvp-tfim-L32-D256-c64"
    r = run.measure(name, 2 ** 31 + 23, 1.0, True, "cpu", root=tiny_root)
    assert r["correct"]
    mix = traffic.mix(traffic.cell(name, tiny_root)["traffic"], tiny_root)
    exponentials = 2 * (2 * mix["L"] - 1)
    m = r["metrics"]
    assert m["matvecs.step"]["value"] == mix["evolve"]["solver"][
        "expalg_m"] * exponentials
    assert 0 < m["expm_span_pct.step"]["value"] < 100
    assert 0 < m["sync_wait_pct.step"]["value"] < 100
    assert "idle_in_krylov_pct.step" not in m


def test_every_new_metric_probes_the_recorded_unit(monkeypatch):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in spec["per_layer"]}
    assert list(entries)[-len(NEW):] == NEW
    recorded = object()
    monkeypatch.setattr(program_trace, "unit_spans", lambda rec: recorded)
    for name in NEW:
        mod = traffic.load_module(
            ROOT / "benchmark" / "metrics" / f"{name}.py", f"_metric_{name}")
        assert mod.probe(None) is recorded
        assert entries[name]["source"] in ("program_span", "program_counter")
