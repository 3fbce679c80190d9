#!/usr/bin/env python3
"""The benchmark of mpskit_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of BENCHMARK.json from the root of a checkout: set-up from
the seed (the random starts, one warm unit), a window of whole units that
ends with the first unit to finish after --seconds, and then the check of
every answer the window produced against the plain reference. The last
line of standard output is the result as one JSON object; the numbers
compared, each with its limit, are the last lines of standard error. With
--trace 0 the metrics are the cell's end-to-end ones; with --trace 1 its
per-layer ones, read in the window and in a few units after it. See
benchmark/README.md."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "mpskit_tpu")


class WindowClosed(Exception):
    """Raised at the end of the first unit to finish after the deadline."""


def run_window(wl, seconds: float, device) -> tuple:
    """Whole units of the workload's work until one ends after `seconds`;
    returns (units, wall seconds)."""
    from benchmark.traffic import synchronize

    units = 0
    end = {}
    synchronize(device)
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def on_unit():
        nonlocal units
        synchronize(device)
        units += 1
        now = time.perf_counter()
        if now >= deadline:
            end["t"] = now
            raise WindowClosed

    try:
        while True:
            wl.work(on_unit)
    except WindowClosed:
        pass
    return units, end["t"] - t0


def cell_metrics(spec: dict, entry: dict, key: str) -> list:
    """The metrics of `key` ("end_to_end" or "per_layer") this cell
    reports: those that list it, or that list no cells and move an
    end-to-end metric the cell reports."""
    e2e = {m["name"] for m in spec["end_to_end"]
           if entry["name"] in m.get("workloads", [entry["name"]])}
    out = []
    for m in spec[key]:
        if "workloads" in m:
            if entry["name"] in m["workloads"]:
                out.append(m)
        elif key == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def aggregate(answers: list, limits: dict) -> tuple:
    """(checks, failed): the largest reading of each number over the
    answers beside its limit, and how many answers read above a limit (a
    reading that is not a number fails)."""
    checks, failed = {}, 0
    for nums in answers:
        bad = False
        for k, v in nums.items():
            c = checks.setdefault(k, {"value": v, "limit": limits[k]})
            if not v <= c["value"]:
                c["value"] = v
            bad |= not v <= limits[k]
        failed += bad
    return checks, failed


def measure(name: str, seed: int, seconds: float, trace: bool, device,
            t_start: float = T_START, root: Path = ROOT) -> dict:
    """Run one cell of the checkout at `root` on `device` and return the
    result object."""
    import torch

    from benchmark import profiling, traffic
    from mpskit_tpu_torch.utils import sync

    spec = traffic.load_json(root / "BENCHMARK.json")
    entry = traffic.cell(name, root)
    cfg = traffic.config(entry["config"], root)
    mix = traffic.mix(entry["traffic"], root)
    metric_dir = root / "benchmark" / "metrics"
    layer = ([(m, traffic.load_module(metric_dir / f"{m['name']}.py",
                                      f"_metric_{m['name']}"))
              for m in cell_metrics(spec, entry, "per_layer")]
             if trace else [])

    wl = traffic.workload(cfg, mix, seed, device, root)
    wl.warm()
    traffic.synchronize(device)
    setup_s = time.perf_counter() - t_start

    counts = collections.Counter()
    count_targets = sorted({t for _, mod in layer
                            for t in getattr(mod, "COUNT", [])})
    syncs0 = sync.count
    with profiling.counted(count_targets, counts):
        units, window_s = run_window(wl, seconds, device)
    syncs = sync.count - syncs0
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    metrics, breakdown, dev_extra = {}, None, {}
    if trace:
        split_targets = sorted({t for _, mod in layer
                                for t in getattr(mod, "SPLIT", [])})
        # what the per-layer metrics' readers read
        rec = types.SimpleNamespace(
            unit=wl.unit, units=units, window_s=window_s, syncs=syncs,
            counts=counts, cfg=cfg, mix=mix, device=device, seed=seed,
            split=None, profile=None)
        t0 = time.perf_counter()
        if split_targets:
            rec.split = profiling.split(wl, split_targets,
                                        mix["split_units"], device)
        t1 = time.perf_counter()
        if cuda:
            rec.profile = profiling.profile_unit(wl, device)
            breakdown = {k: rec.profile[k] for k in ("device_ops",
                                                     "idle_gaps")}
            dev_extra = {"busy_s": rec.profile["busy_s"],
                         "window_s": rec.profile["window_s"]}
        t2 = time.perf_counter()
        rec.probes = {m["name"]: mod.probe(rec) for m, mod in layer
                      if hasattr(mod, "probe")}
        print(f"trace: split {t1 - t0:.1f} s, profile {t2 - t1:.1f} s, "
              f"probes {time.perf_counter() - t2:.1f} s", file=sys.stderr)
        for m, mod in layer:
            value = mod.read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(spec, entry, "end_to_end"):
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == f"{wl.unit}_s":
                value = window_s / units
            else:
                raise SystemExit(f"benchmark: the cell's {wl.unit}s give no "
                                 f"end-to-end metric {m['name']!r}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check, once the window has closed and its peak is read
    t0 = time.perf_counter()
    answers = wl.check()
    print(f"check: {len(answers)} answers in {time.perf_counter() - t0:.1f}"
          " s", file=sys.stderr)
    checks, failed = aggregate(answers, mix["limits"])
    correct = bool(answers) and failed == 0 and set(checks) == set(
        mix["limits"])
    result = {
        "correct": correct, "attempted": len(answers), "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": entry["chips"], "memory_peak_bytes": peak, **dev_extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import traffic

    chips = traffic.cell(args.workload, ROOT)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = measure(args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
