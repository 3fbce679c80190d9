#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process on the
card: the check's numbers of sound runs on many seeds, and of the control,
the same runs with the program's float32 matmuls in TF32 (the nearest
precision below the float32 with TF32 off that every configuration here
states; `config.matmul_precision` switched to allow it).

    python3 benchmark/control.py --workload <name> --seconds <s> \\
        --seeds 1 2 3 ... [--control-seeds 101 102 103] \\
        [--control-seconds <s>]

One JSON line per run ({"seed", "control", "correct", "checks"}), then for
each number the largest sound reading and the smallest control reading.
The benchmark's own runs never run this."""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


@contextlib.contextmanager
def tf32():
    """Every float32 matmul of the program in TF32: the program's pin of
    exact float32 (`config.matmul_precision`, imported by name into each
    module) replaced by one that allows TF32, and TF32 on outside it."""
    import torch

    import mpskit_tpu_torch.config as config

    pin = config.matmul_precision

    @contextlib.contextmanager
    def allow():
        yield

    saved = [m for m in list(sys.modules.values())
             if getattr(m, "__name__", "").startswith("mpskit_tpu_torch")
             and getattr(m, "matmul_precision", None) is pin]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    for m in saved:
        m.matmul_precision = allow
    try:
        yield
    finally:
        for m in saved:
            m.matmul_precision = pin
        torch.backends.cuda.matmul.allow_tf32 = prev


def readings(workload: str, seconds: float, seeds, control_seeds,
             device="cuda", root=None, control_seconds=None) -> list:
    """One result per seed: sound runs, then control runs (windows of
    `control_seconds`, default `seconds`: a control may run slower and
    needs whole answers in its window too)."""
    import torch

    from benchmark import run

    kw = {} if root is None else {"root": root}
    out = []
    for control, group in ((False, seeds), (True, control_seeds)):
        for seed in group:
            ctx = tf32() if control else contextlib.nullcontext()
            with ctx:
                r = run.measure(workload, seed, (control_seconds or seconds)
                                if control else seconds, False, device,
                                t_start=time.perf_counter(), **kw)
            out.append({"seed": seed, "control": control,
                        "correct": r["correct"], "checks": r["checks"],
                        "metrics": r["metrics"]})
            print(json.dumps(out[-1]), flush=True)
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    return out


def summary(rows: list) -> dict:
    """For each number: the largest sound reading, the smallest control
    reading."""
    names = {k for r in rows for k in r["checks"]}
    out = {}
    for k in sorted(names):
        sound = [r["checks"][k]["value"] for r in rows
                 if not r["control"] and k in r["checks"]]
        ctrl = [r["checks"][k]["value"] for r in rows
                if r["control"] and k in r["checks"]]
        out[k] = {"sound_max": max(sound, default=None),
                  "control_min": min(ctrl, default=None)}
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seconds", type=float)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    rows = readings(args.workload, args.seconds, args.seeds,
                    args.control_seeds, control_seconds=args.control_seconds)
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
