"""Plain PyTorch references of the served model families, one module per
family (``<family>.py``), each with ``weight_spec(cfg)`` and
``served_logits(cfg, sem, weights, prompts, served, device)``.  They import
neither JAX nor anything of the program; they work everything out again
from the weights and tokens the benchmark made."""
