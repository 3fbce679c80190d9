"""operators of the PyTorch port (see mpskit_tpu/operators)."""
