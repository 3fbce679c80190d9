"""Fixtures of the benchmark's CPU tests: a copy of the benchmark whose
mixes run at tiny sizes, so that a whole run takes seconds on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

# the tests run on several workers: one thread each keeps them from
# crowding each other's solves out of their windows
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each mix's sizes cut so that one solve or step takes well under a second
TINY = {
    "dmrg-tfim-L32-D512-f32": {"L": 8, "D": 16, "solver": {"maxiter": 3}},
    "dmrg2-heis1-L32-D256-f32": {"L": 6, "D": 27,
                                 "solver": {"maxiter": 2, "truncdim": 27}},
    "tdvp-tfim-L32-D256-c64": {"L": 8, "D": 16},
}
CELLS = sorted(TINY)


def _merge(base: dict, new: dict) -> dict:
    out = dict(base)
    for k, v in new.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) else v
    return out


def tiny_copy(dest: Path) -> Path:
    """BENCHMARK.json and benchmark/ copied under dest, the mixes cut to
    the TINY sizes; returns dest."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, cut in TINY.items():
        path = dest / "benchmark" / "mixes" / f"{name}.json"
        path.write_text(json.dumps(_merge(json.loads(path.read_text()), cut)))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return tiny_copy(tmp_path)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
