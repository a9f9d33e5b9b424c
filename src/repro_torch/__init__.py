"""PyTorch/CUDA port of the Armol reproduction (``repro``).

Same module names and layout as ``repro``; imports torch and numpy, never
JAX and nothing of ``repro``.  Entry points run on the GPU unless the
caller passes ``device="cpu"``, and raise where there is no GPU.  The
pairwise-IoU TPU kernel is a hand-written CUDA kernel here
(``repro_torch.kernels.iou_matrix``).
"""
