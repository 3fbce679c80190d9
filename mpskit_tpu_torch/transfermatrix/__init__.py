"""transfermatrix of the PyTorch port (see mpskit_tpu/transfermatrix)."""
