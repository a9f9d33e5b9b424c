"""LM substrate of the port: layers, GQA, MLA and cross attention, MoE,
Mamba-2 blocks and the model facade of the six families (serving and
training)."""
