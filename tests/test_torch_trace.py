"""The port's spans (mpskit_tpu_torch/utils/trace.py): what a recording
holds after a tiny DMRG, DMRG2, TDVP, VUMPS or VUMPS scan run on the
CPU, how the spans nest, the scan's finalize hook,
that they agree with the program's counters and with torch.profiler's
clock, and that recording changes no result. One test needs a CUDA card
(marker `cuda`) and skips without one. The file imports no jax."""

import collections
import time

import pytest
import torch

import mpskit_tpu_torch as mt
from mpskit_tpu_torch.algorithms import dmrg, dmrg2, tdvp, vumps
from mpskit_tpu_torch.environments import infinite_ham
from mpskit_tpu_torch.linalg.lanczos import eigsh_smallest
from mpskit_tpu_torch.utils import sync, trace

L, D, M = 6, 12, 8
SLACK_NS = 50_000


def _start(dtype=torch.float64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return mt.FiniteMPS.random(L, 2, D, dtype, "cpu", gen)


def _hamiltonian(g=1.5):
    return mt.transverse_field_ising_lattice(g=g)


def _dmrg():
    return mt.find_groundstate(_start(), _hamiltonian(),
                               mt.DMRG(maxiter=1, verbosity=0))


def _dmrg2():
    return mt.find_groundstate(
        _start(), _hamiltonian(),
        mt.DMRG2(maxiter=1, trscheme=mt.truncdim(D), verbosity=0))


def _complex_start():
    psi = _start()
    c = torch.complex128
    return mt.FiniteMPS(psi.ALs.to(c), psi.ARs.to(c), psi.AC.to(c),
                        psi.center)


def _tdvp():
    return mt.timestep(_complex_start(), _hamiltonian(0.5), 0.0, 0.05,
                       mt.TDVP(expalg_m=M))


def _vumps():
    """One VUMPS iteration on a 3-site cell of the J1-J2 cylinder."""
    gen = torch.Generator().manual_seed(0)
    psi = mt.InfiniteMPS.random(3, 2, 8, torch.float64, "cpu", gen)
    return mt.find_groundstate(psi, mt.j1_j2_model(width=3),
                               mt.VUMPS(maxiter=1, verbosity=0))


def _scan(finalize=None, maxiter=2):
    """A lockstep VUMPS scan of the TFIM at g = 1.2 and 2.0 (one-site
    cells, D=6) for `maxiter` iterations."""
    psis = [mt.InfiniteMPS.random(1, 2, 6, torch.float64, "cpu",
                                  torch.Generator().manual_seed(30 + b))
            for b in range(2)]
    Hs = [mt.transverse_field_ising(g=g) for g in (1.2, 2.0)]
    return mt.scan_groundstate_vumps(
        psis, Hs, mt.VUMPS(maxiter=maxiter, tol=0.0, verbosity=0,
                           finalize=finalize))


RUNS = {"dmrg": _dmrg, "dmrg2": _dmrg2, "tdvp": _tdvp, "vumps": _vumps,
        "scan": lambda: (_scan().psis,)}
# the module attributes through which each algorithm calls its matvecs
MATVECS = {
    "dmrg": [(dmrg, "ac_apply"), (dmrg, "ac_apply_fast")],
    "dmrg2": [(dmrg2, "ac2_apply")],
    "tdvp": [(tdvp, "ac_apply"), (tdvp, "c_apply")],
    "vumps": [(vumps, "ac_apply"), (vumps, "c_apply")],
    "scan": [(vumps, "ac_apply"), (vumps, "c_apply")],
}


def _recorded(run):
    with trace.recording() as rec:
        out = run()
    return rec, out


def _by_id(rec):
    return {s.id: s for s in rec.spans}


def _children(rec, parent_name):
    """Counter of (parent id, child name) under the spans named
    parent_name."""
    by = _by_id(rec)
    return collections.Counter(
        (s.parent, s.name) for s in rec.spans
        if s.parent is not None and by[s.parent].name == parent_name)


def test_nothing_recorded_without_a_recording():
    """With no recording open a span is one shared no-op context, and a
    run leaves nothing in a recording opened after it."""
    assert trace._open is None
    assert trace.span("sweep") is trace.span("matvec", "exact")
    _dmrg()
    with trace.recording() as rec:
        pass
    assert rec.spans == [] and not rec.counts
    assert trace._open is None


def test_one_recording_at_a_time():
    with trace.recording():
        with pytest.raises(RuntimeError):
            trace.recording().__enter__()
    assert trace._open is None


def test_dmrg_sweep_nests_eigsh_matvec_sync():
    rec, _ = _recorded(_dmrg)
    by = _by_id(rec)
    assert len(by) == len(rec.spans)
    sweeps = [s for s in rec.spans if s.name == "sweep"]
    assert len(sweeps) == 1 and sweeps[0].parent is None
    eigsh = [s for s in rec.spans if s.name == "eigsh"]
    assert len(eigsh) == 2 * (L - 1)
    assert all(s.parent == sweeps[0].id for s in eigsh)
    under = _children(rec, "eigsh")
    for s in eigsh:
        assert under[(s.id, "matvec")] >= 1
        assert under[(s.id, "sync")] >= 1
    for s in rec.spans:
        if s.parent is not None:
            p = by[s.parent]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
            assert p.id < s.id
    kinds = {s.kind for s in rec.spans if s.name == "matvec"}
    assert kinds == {"exact"}
    under = _children(rec, "sweep")
    # one gauge move and one environment push per site solve
    assert under[(sweeps[0].id, "qr")] == 2 * (L - 1)
    assert under[(sweeps[0].id, "push")] == 2 * (L - 1)


def test_dmrg2_sweep_has_svd_spans():
    rec, _ = _recorded(_dmrg2)
    by = _by_id(rec)
    svd = [s for s in rec.spans if s.name == "svd"]
    assert len(svd) == 2 * (L - 1)
    assert all(by[s.parent].name == "sweep" for s in svd)
    assert {s.kind for s in rec.spans if s.name == "matvec"} == {"two-site"}


def test_tdvp_step_nests_expm_with_m_matvecs():
    rec, _ = _recorded(_tdvp)
    steps = [s for s in rec.spans if s.name == "step"]
    assert len(steps) == 1 and steps[0].parent is None
    expm = [s for s in rec.spans if s.name == "expm"]
    # L site exponentials and L - 1 bond exponentials each way
    assert len(expm) == 2 * (2 * L - 1)
    assert all(s.parent == steps[0].id for s in expm)
    under = _children(rec, "expm")
    assert all(under[(s.id, "matvec")] == M for s in expm)
    assert rec.counts["matvec"] == M * len(expm)
    assert {s.kind for s in rec.spans if s.name == "matvec"} == {
        "exact", "zero-site"}


def _count_gmres_operator(monkeypatch) -> list:
    """Wrap the operator that the infinite walk hands each GMRES solve;
    the returned list's one item counts its calls."""
    calls = [0]
    real = infinite_ham.linsolve_info

    def counted(matvec, b, *args, **kwargs):
        def mv(x):
            calls[0] += 1
            return matvec(x)
        return real(mv, b, *args, **kwargs)

    monkeypatch.setattr(infinite_ham, "linsolve_info", counted)
    return calls


def test_vumps_iteration_nests_envs_gmres_eigsh_matvec(monkeypatch):
    """One iteration: the walk (`envs`, with its GMRES) and a site and a
    bond eigensolve for each of the 3 sites, under the `iteration` root;
    the final environments of the returned state open one more `envs`.
    The `gmres_op` count is the number of calls a wrapper of the solves'
    operators counts."""
    applied = _count_gmres_operator(monkeypatch)
    rec, _ = _recorded(_vumps)
    by = _by_id(rec)
    (it,) = [s for s in rec.spans if s.name == "iteration"]
    assert it.parent is None and it.kind == "vumps"
    envs = [s for s in rec.spans if s.name == "envs"]
    assert len(envs) == 2 and {s.kind for s in envs} == {"infinite"}
    assert [s.parent for s in envs].count(it.id) == 1
    assert all(by[s.parent].name == "envs"
               for s in rec.spans if s.name == "gmres")
    assert rec.counts["gmres"] >= 2
    eigsh = [s for s in rec.spans if s.name == "eigsh"]
    assert len(eigsh) == 6 and all(s.parent == it.id for s in eigsh)
    under = _children(rec, "eigsh")
    kinds = collections.Counter()
    for s in rec.spans:
        if s.name == "matvec":
            assert by[s.parent].name == "eigsh"
            kinds[s.kind] += 1
    assert set(kinds) == {"exact", "zero-site"}
    assert all(under[(s.id, "matvec")] >= 1 for s in eigsh)
    assert rec.counts["gmres_op"] == applied[0] > 0


def test_scan_iteration_nests_its_members_and_calls_finalize():
    """Three lockstep iterations of a two-member scan: one root `scan`
    span (kind vumps) each, holding the two members' `iteration` spans,
    and one finalize call after each, with the iteration count and the
    members' states and Hamiltonians, once its span has closed."""
    calls = []

    def finalize(it, members, Hs):
        calls.append((it, len(members), len(Hs), trace._open._stack[:]))

    rec, res = _recorded(lambda: _scan(finalize, 3))
    scans = [s for s in rec.spans if s.name == "scan"]
    assert len(scans) == res.iterations == 3
    assert all(s.parent is None and s.kind == "vumps" for s in scans)
    under = _children(rec, "scan")
    its = [s for s in rec.spans if s.name == "iteration"]
    assert len(its) == 6 and all(under[(s.id, "iteration")] == 2
                                 for s in scans)
    assert [c[:3] for c in calls] == [(1, 2, 2), (2, 2, 2), (3, 2, 2)]
    assert all(c[3] == [] for c in calls)


def test_scan_results_unchanged_by_its_hook():
    """A hook that returns nothing, or the members it was given, leaves
    every energy and tensor as the run without one; a returned list
    replaces the members (both members the first one's state)."""
    plain = _scan(maxiter=3)
    for hook in (lambda it, m, H: None, lambda it, m, H: m):
        res = _scan(hook, 3)
        assert torch.equal(res.energies, plain.energies)
        for f in ("AL", "AR", "AC", "C"):
            assert torch.equal(getattr(res.psis, f),
                               getattr(plain.psis, f))
    res = _scan(lambda it, m, H: [m[0], m[0]] if it == 3 else None, 3)
    assert torch.equal(res.psis.AL[0], res.psis.AL[1])
    assert not torch.equal(res.psis.AL[1], plain.psis.AL[1])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sync_spans_equal_the_sync_counter(name):
    before = sync.count
    rec, _ = _recorded(RUNS[name])
    assert rec.counts["sync"] == sync.count - before > 0


@pytest.mark.parametrize("name", sorted(RUNS))
def test_matvec_spans_equal_the_calls_a_wrapper_counts(name, monkeypatch):
    calls = collections.Counter()
    for mod, attr in MATVECS[name]:
        fn = getattr(mod, attr)

        def counted(*args, _fn=fn, _attr=attr):
            calls[_attr] += 1
            return _fn(*args)

        monkeypatch.setattr(mod, attr, counted)
    rec, _ = _recorded(RUNS[name])
    assert rec.counts["matvec"] == sum(calls.values()) > 0


def test_span_closes_when_an_exception_passes():
    with trace.recording() as rec:
        with pytest.raises(ValueError):
            with trace.span("outer"):
                with trace.span("inner"):
                    raise ValueError
        calls = []

        def failing(x):
            calls.append(1)
            if len(calls) == 3:
                raise FloatingPointError
            return 2.0 * x

        with pytest.raises(FloatingPointError):
            eigsh_smallest(failing, torch.ones(5, dtype=torch.float64), 4)
        with trace.span("after"):
            pass
    names = [s.name for s in rec.spans]
    assert names == ["inner", "outer", "eigsh", "after"]
    by = _by_id(rec)
    assert by[rec.spans[0].parent].name == "outer"
    assert rec.spans[-1].parent is None and rec._stack == []


@pytest.mark.parametrize("name", sorted(RUNS))
def test_results_equal_with_recording_on_and_off(name):
    off = RUNS[name]()
    _, on = _recorded(RUNS[name])
    a, b = off[0], on[0]
    fields = (("AL", "AR", "AC", "C") if isinstance(a, mt.InfiniteMPS)
              else ("ALs", "ARs", "AC"))
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f))


def test_spans_lie_on_the_profilers_clock():
    """A record_function range opened inside a span lies within the
    span's interval, up to SLACK_NS at each end."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording() as rec:
            for i in range(5):
                with trace.span("outer"):
                    with record_function(f"inner{i}"):
                        x @ x
                time.sleep(1e-3)
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("inner")}
    assert len(ranges) == len(rec.spans) == 5
    for i, s in enumerate(rec.spans):
        a, b = ranges[f"inner{i}"]
        assert s.t0_ns - SLACK_NS <= a <= b <= s.t1_ns + SLACK_NS


@pytest.mark.cuda
def test_span_contains_its_kernel_on_the_card():
    """A span around a sleeping kernel and a synchronize contains the
    kernel's device interval from torch.profiler, up to SLACK_NS."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with trace.recording() as rec:
            for _ in range(5):
                with trace.span("wait"):
                    torch.cuda._sleep(2_000_000)
                    torch.cuda.synchronize()
    # the sleeping kernel (ATen's spin_kernel) is the only device operation
    # of the profile that lasts 0.1 ms or more
    kernels = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA
        and e.duration_ns() >= 100_000)
    assert len(kernels) == len(rec.spans) == 5
    for (a, b), s in zip(kernels, rec.spans):
        assert s.t0_ns - SLACK_NS <= a <= b <= s.t1_ns + SLACK_NS
