"""PyTorch/CUDA port of the Armol reproduction (``repro``).

Same module names and layout as ``repro``; imports torch and numpy, never
JAX and nothing of ``repro``.  Entry points run on the GPU unless the
caller passes ``device="cpu"``, and raise where there is no GPU.  The
reference's TPU kernels are hand-written CUDA kernels here: pairwise IoU
for the federation (``kernels.iou_matrix``), flash attention and the
Mamba-2 SSD scan for the LM engine (``kernels.flash_attention``,
``kernels.ssd_scan``).
"""
