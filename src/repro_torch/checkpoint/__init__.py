"""Checkpoints of the port (counterpart of ``repro.checkpoint``)."""
from repro_torch.checkpoint.store import load_pytree, save_pytree  # noqa: F401
