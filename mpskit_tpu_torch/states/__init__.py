"""states of the PyTorch port (see mpskit_tpu/states)."""
