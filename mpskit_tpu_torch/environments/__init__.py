"""environments of the PyTorch port (see mpskit_tpu/environments)."""
