"""Mamba-2 SSD chunk scan: CUDA kernel (``csrc/``), plain version
(``ref``), checked wrapper (``ops``)."""
