"""models of the PyTorch port (see mpskit_tpu/models)."""
