"""tensors of the PyTorch port (see mpskit_tpu/tensors)."""
