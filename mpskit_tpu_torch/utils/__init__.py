"""utils of the PyTorch port (see mpskit_tpu/utils)."""
