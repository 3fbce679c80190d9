"""Percent of the wall time of steps in the Lanczos exponentials of TDVP,
linalg/expm.py expm_multiply_err: a split by synchronizations over a few
steps after the window."""

from benchmark.profiling import split_share

SPLIT = [
    'mpskit_tpu_torch.algorithms.tdvp:expm_multiply_err',
]


def read(rec):
    return split_share(rec, "step", SPLIT)
