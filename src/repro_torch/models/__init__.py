"""LM substrate of the port: layers, GQA attention, Mamba-2 blocks and the
model facade (the hybrid family so far)."""
