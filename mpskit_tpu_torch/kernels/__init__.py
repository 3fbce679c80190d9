"""Hand-written CUDA kernels of the port (sources in csrc/, built by
build.py at first use), each beside its plain PyTorch version."""
