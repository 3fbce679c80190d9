"""Percent of the wall time of sweeps in the truncated splits of DMRG2,
tensors/ops.py svd_truncated (cuSOLVER gesvd): a split by
synchronizations over a few sweeps after the window."""

from benchmark.profiling import split_share

SPLIT = [
    'mpskit_tpu_torch.algorithms.dmrg2:svd_truncated',
]


def read(rec):
    return split_share(rec, "sweep", SPLIT)
