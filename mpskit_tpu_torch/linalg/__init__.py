"""linalg of the PyTorch port (see mpskit_tpu/linalg)."""
