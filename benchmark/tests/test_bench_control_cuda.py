"""On the card: the control (the program's float32 matmuls in TF32) comes
out not correct where sound runs of the same seeds come out correct, at
sizes a test run holds. The benchmark's own runs never run it."""

import pytest

from benchmark import control


@pytest.mark.cuda
@pytest.mark.parametrize("name, seconds", [
    ("dmrg-tfim-L32-D512-f32", 2.0), ("tdvp-tfim-L32-D256-c64", 2.0),
    ("dmrg2-heis1-L32-D256-f32", 2.0)])
def test_control_fails_where_sound_runs_pass(tiny_root, cuda_device, name,
                                             seconds):
    rows = control.readings(name, seconds, [1, 2, 3], [1, 2, 3],
                            device=cuda_device, root=tiny_root)
    assert all(r["correct"] for r in rows if not r["control"])
    assert not any(r["correct"] for r in rows if r["control"])
