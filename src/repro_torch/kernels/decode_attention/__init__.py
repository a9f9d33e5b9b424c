"""Decode attention: CUDA kernel (``csrc/``), plain version (``ref``),
checked wrapper (``ops``)."""
