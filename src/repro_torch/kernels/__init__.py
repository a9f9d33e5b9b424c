"""Hand-written CUDA kernels of the port, one package per kernel: the
kernel source under ``csrc/``, its plain PyTorch version in ``ref.py``
and its checked wrapper with a launch counter in ``ops.py``."""
