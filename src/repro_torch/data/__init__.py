"""Synthetic LM data (``pipeline``)."""
