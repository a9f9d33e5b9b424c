"""Mamba-2 one-token step: CUDA kernel (``csrc/``), plain version
(``ref``), checked wrapper (``ops``)."""
