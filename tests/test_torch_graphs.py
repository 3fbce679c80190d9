"""Bound matvecs and the CUDA graphs of the full Lanczos factorization
(mpskit_tpu_torch/linalg/graphs.py, linalg/lanczos.py): on the CPU a Bound
runs exactly as a lambda, the graph cache's bookkeeping, and trace.count;
on a card (marker `cuda`, skipped without one) the replayed factorization
against the eager one. The file imports no jax, so it also runs where jax
is not installed:

    python -m pytest tests/test_torch_graphs.py --noconftest -o addopts="" -q
"""

import collections
import tracemalloc

import pytest
import torch

import mpskit_tpu_torch as mt
from mpskit_tpu_torch.algorithms import tdvp
from mpskit_tpu_torch.algorithms.derivatives import ac_apply, c_apply
from mpskit_tpu_torch.config import matmul_precision
from mpskit_tpu_torch.linalg import graphs
from mpskit_tpu_torch.linalg.expm import expm_multiply_err
from mpskit_tpu_torch.linalg.graphs import Bound
from mpskit_tpu_torch.linalg.lanczos import lanczos_factorize
from mpskit_tpu_torch.utils import trace

M = 8


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")


def _operands(kind, D, d, w, dtype, device, seed):
    """(fn, operands, x) of a one-site or zero-site effective Hamiltonian
    with Hermitian environments, as TDVP's exponentials see them."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        t = torch.randn(shape, generator=gen, dtype=torch.float64)
        if dtype.is_complex:
            t = torch.complex(t, torch.randn(shape, generator=gen,
                                             dtype=torch.float64))
        return t

    def herm(t):
        return (t + t.transpose(-1, -2).conj()) / (2 * D)

    GL, GR = herm(rand(w, D, D)), herm(rand(w, D, D))
    W = rand(w, w, d, d)
    W = (W + W.permute(0, 1, 3, 2).conj()) / 2
    if kind == "ac":
        fn, ops, x = ac_apply, (GL, W, GR), rand(D, d, D)
    else:
        fn, ops, x = c_apply, (GL, GR), rand(D, D)
    return fn, [t.to(dtype=dtype, device=device) for t in ops], \
        x.to(dtype=dtype, device=device)


def _lambda(fn, *ops):
    return lambda x: fn(*ops, x)


def _quench_start(L, D, dtype, device):
    gen = torch.Generator(device=device).manual_seed(3)
    psi = mt.FiniteMPS.random(L, 2, D, torch.float64, device, gen)
    return mt.FiniteMPS(psi.ALs.to(dtype), psi.ARs.to(dtype),
                        psi.AC.to(dtype), psi.center)


def _eager_tdvp(monkeypatch):
    """The finite TDVP step with lambdas in place of Bound, as before."""
    monkeypatch.setattr(tdvp, "Bound", _lambda)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
@pytest.mark.parametrize("kind", ["ac", "c"])
def test_expm_with_bound_equals_the_lambda_bit_for_bit(kind, dtype):
    fn, ops, x = _operands(kind, 12, 2, 3, dtype, "cpu", seed=1)
    y_b, err_b = expm_multiply_err(Bound(fn, *ops), x, -0.025j, M)
    y_l, err_l = expm_multiply_err(_lambda(fn, *ops), x, -0.025j, M)
    assert torch.equal(y_b, y_l) and err_b == err_l


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_finite_tdvp_step_with_bound_equals_lambdas_bit_for_bit(
        dtype, monkeypatch):
    psi = _quench_start(6, 8, dtype, "cpu")
    H = mt.transverse_field_ising_lattice(g=0.5)
    alg = mt.TDVP(expalg_m=M)
    out, _ = mt.timestep(psi, H, 0.0, 0.05, alg)
    _eager_tdvp(monkeypatch)
    ref, _ = mt.timestep(psi, H, 0.0, 0.05, alg)
    for name in ("ALs", "ARs", "AC"):
        assert torch.equal(getattr(out, name), getattr(ref, name))


def test_bound_calls_its_function_with_the_operands_first():
    seen = []
    b = Bound(lambda *args: seen.append(args) or 7, 1, 2)
    assert b(3) == 7 and seen == [(1, 2, 3)]
    assert b.operands == (1, 2)


def test_count_adds_only_while_a_recording_is_open():
    trace.count("matvec", 5)
    with trace.recording() as rec:
        trace.count("matvec", 20)
        trace.count("matvec")
        trace.count("other", 3)
    trace.count("matvec", 5)
    assert rec.counts == collections.Counter({"matvec": 21, "other": 3})
    assert rec.spans == []


def test_count_allocates_nothing_without_a_recording():
    assert trace._open is None
    trace.count("matvec", 20)  # any lazy set-up happens before tracing
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            trace.count("matvec", 20)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, trace.__file__)]
    grown = after.filter_traces(only).compare_to(
        before.filter_traces(only), "filename")
    assert sum(d.size_diff for d in grown) == 0


def test_paused_records_nothing_and_resumes():
    with trace.recording() as rec:
        with trace.span("step"):
            with trace.paused():
                assert trace._open is None
                with trace.span("matvec"):
                    trace.count("matvec", 4)
            trace.count("matvec", 2)
    assert [s.name for s in rec.spans] == ["step"]
    assert rec.counts == collections.Counter({"step": 1, "matvec": 2})
    assert trace._open is None


@pytest.mark.parametrize("kind", ["ac", "c"])
def test_cpu_factorization_never_touches_the_graph_cache(kind, monkeypatch):
    """On the CPU, for a lambda and for a Bound alike, the factorization
    runs its eager steps: no capture, no replay, no graph kept."""
    def refuse(*args, **kwargs):
        raise AssertionError("the graph path was taken")

    monkeypatch.setattr(graphs, "replayed", refuse)
    fn, ops, x = _operands(kind, 10, 2, 3, torch.complex128, "cpu", seed=2)
    before = (graphs.captures, graphs.replays, len(graphs._graphs))
    assert not graphs.capturable(_lambda(fn, *ops), x)
    assert not graphs.capturable(Bound(fn, *ops), x)
    for mv in (_lambda(fn, *ops), Bound(fn, *ops)):
        V, alpha, beta, nvalid = lanczos_factorize(mv, x, M)
        assert V.shape == (M + 1,) + tuple(x.shape) and nvalid == M
    assert (graphs.captures, graphs.replays, len(graphs._graphs)) == before


def test_key_holds_each_operands_layout():
    """A transposed operand is another key: the static copies keep the
    layout, so that a replay launches what the eager call would."""
    x = torch.zeros(4, 6, dtype=torch.complex64)
    assert graphs.signature(x) != graphs.signature(x.t().contiguous().t())
    assert graphs.signature(x) == graphs.signature(torch.ones_like(x))
    assert graphs.signature(x) != graphs.signature(x.to(torch.complex128))
    y = x.t()
    assert y.clone().stride() == y.stride()


class _FakeGraph:
    """A graph whose replay recomputes body on the static inputs."""

    def __init__(self, body, statics, outputs):
        self.body, self.statics, self.outputs = body, statics, outputs

    def replay(self):
        self.outputs.copy_(self.body(*self.statics))


def _fake_capture(body, inputs):
    statics = [x.clone() for x in inputs]
    outputs = body(*statics)
    return _FakeGraph(body, statics, outputs), statics, outputs


def test_cache_captures_once_per_key_and_drops_the_oldest(monkeypatch):
    """The bookkeeping of `replayed`, with the capture replaced by a CPU
    stand-in: one capture per key, the inputs copied in on every call,
    the outputs the graph's own tensor, the least recently used key
    dropped past the cache's size."""
    monkeypatch.setattr(graphs, "_capture", _fake_capture)
    monkeypatch.setattr(graphs, "_graphs", collections.OrderedDict())
    c0, r0 = graphs.captures, graphs.replays

    def body(a, b):
        return a * b

    x, y = torch.arange(4.0), torch.full((4,), 2.0)
    out1 = graphs.replayed("k0", body, (x, y))
    assert torch.equal(out1, x * y)
    out2 = graphs.replayed("k0", body, (y, y))
    assert out2 is out1 and torch.equal(out2, y * y)
    assert (graphs.captures - c0, graphs.replays - r0) == (1, 2)
    for k in range(1, graphs._CACHE_SIZE):
        graphs.replayed(f"k{k}", body, (x, y))
    graphs.replayed("k0", body, (x, x))  # k0 is now the newest
    graphs.replayed("new", body, (x, y))
    assert len(graphs._graphs) == graphs._CACHE_SIZE
    assert "k0" in graphs._graphs and "k1" not in graphs._graphs
    assert graphs.captures - c0 == graphs._CACHE_SIZE + 1


def test_capture_and_replay_spans_inside_a_recording(monkeypatch):
    """A capture is one `capture` span with nothing recorded inside it; a
    replay is one `replay` span."""
    monkeypatch.setattr(graphs, "_capture", _fake_capture)
    monkeypatch.setattr(graphs, "_graphs", collections.OrderedDict())

    seen = []

    def body(a):
        seen.append(trace._open)
        with trace.span("matvec"):
            return 2 * a

    x = torch.ones(3)
    with trace.recording() as rec:
        graphs.replayed("k", body, (x,), "lanczos")
        graphs.replayed("k", body, (x,), "lanczos")
    assert seen[0] is None  # the capture ran with the recording paused
    assert [(s.name, s.kind) for s in rec.spans
            if s.name != "matvec"] == [("capture", "lanczos"),
                                       ("replay", "lanczos"),
                                       ("replay", "lanczos")]
    assert rec.spans[0].name == "capture"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _close(a, b, tol):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return float((a - b).abs().max()) <= tol * max(float(b.abs().max()),
                                                   1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ac", "c"])
def test_graph_factorization_matches_eager_on_card(kind):
    """Complex64 at the TDVP cell's widths (D=256, d=2, w=3): alpha, beta
    and V to 1e-6 relative of the eager factorization."""
    _need_card()
    fn, ops, x = _operands(kind, 256, 2, 3, torch.complex64, "cuda", 4)
    with matmul_precision():
        Vg, ag, bg, ng = lanczos_factorize(Bound(fn, *ops), x, 20)
        Vg = Vg.clone()
        Ve, ae, be, ne = lanczos_factorize(_lambda(fn, *ops), x, 20)
    assert ng == ne
    assert _close(ag, ae, 1e-6) and _close(bg, be, 1e-6)
    assert _close(Vg.cpu(), Ve.cpu(), 1e-6)


@pytest.mark.cuda
def test_successive_replays_each_match_their_own_eager_result():
    """Two calls of one key with other operands and start vectors: each
    matches its own eager factorization (no stale static buffer)."""
    _need_card()
    with matmul_precision():
        for seed in (5, 6, 7):
            fn, ops, x = _operands("ac", 64, 2, 3, torch.complex64, "cuda",
                                   seed)
            Vg, ag, bg, _ = lanczos_factorize(Bound(fn, *ops), x, 12)
            Ve, ae, be, _ = lanczos_factorize(_lambda(fn, *ops), x, 12)
            assert _close(ag, ae, 1e-6) and _close(bg, be, 1e-6)
            assert _close(Vg.cpu(), Ve.cpu(), 1e-6)


@pytest.mark.cuda
def test_one_capture_per_key_on_card(monkeypatch):
    """One key: one capture and n replays; another shape, or the TF32 flag
    flipped, captures anew."""
    _need_card()
    monkeypatch.setattr(graphs, "_graphs", collections.OrderedDict())
    c0, r0 = graphs.captures, graphs.replays
    with matmul_precision():
        for seed in (8, 9, 10):
            fn, ops, x = _operands("c", 48, 2, 3, torch.complex64, "cuda",
                                   seed)
            lanczos_factorize(Bound(fn, *ops), x, 10)
        assert (graphs.captures - c0, graphs.replays - r0) == (1, 3)
        fn, ops, x = _operands("c", 40, 2, 3, torch.complex64, "cuda", 11)
        lanczos_factorize(Bound(fn, *ops), x, 10)
        assert (graphs.captures - c0, graphs.replays - r0) == (2, 4)
    fn, ops, x = _operands("c", 48, 2, 3, torch.complex64, "cuda", 12)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = not prev
        lanczos_factorize(Bound(fn, *ops), x, 10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert (graphs.captures - c0, graphs.replays - r0) == (3, 5)


@pytest.mark.cuda
def test_complex64_finite_step_with_graphs_matches_eager(monkeypatch):
    """A complex64 TDVP step at L=8 D=32 on the card, its exponentials
    replayed, against the same step with lambdas: every tensor to 1e-6."""
    _need_card()
    psi = _quench_start(8, 32, torch.complex64, "cuda")
    H = mt.transverse_field_ising_lattice(g=0.5)
    r0 = graphs.replays
    out, _ = mt.timestep(psi, H, 0.0, 0.05, mt.TDVP(expalg_m=20))
    assert graphs.replays - r0 == 2 * (2 * 8 - 1)
    _eager_tdvp(monkeypatch)
    ref, _ = mt.timestep(psi, H, 0.0, 0.05, mt.TDVP(expalg_m=20))
    assert graphs.replays - r0 == 2 * (2 * 8 - 1)
    for name in ("ALs", "ARs", "AC"):
        assert _close(getattr(out, name).cpu(), getattr(ref, name).cpu(),
                      1e-6)


@pytest.mark.cuda
def test_replayed_exponentials_count_their_matvecs_on_card():
    """Inside a recording each replayed exponential adds m to the matvec
    count and opens one `replay` span under its `expm` span."""
    _need_card()
    fn, ops, x = _operands("ac", 32, 2, 3, torch.complex64, "cuda", 13)
    with matmul_precision():
        expm_multiply_err(Bound(fn, *ops), x, -0.025j, 16)  # captured here
        with trace.recording() as rec:
            for _ in range(3):
                expm_multiply_err(Bound(fn, *ops), x, -0.025j, 16)
    assert rec.counts["matvec"] == 3 * 16 and rec.counts["expm"] == 3
    by = {s.id: s for s in rec.spans}
    replays = [s for s in rec.spans if s.name == "replay"]
    assert len(replays) == 3 and "capture" not in rec.counts
    assert all(by[s.parent].name == "expm" and s.kind == "lanczos"
               for s in replays)
    assert rec.counts["sync"] == 3
