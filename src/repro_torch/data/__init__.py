"""Synthetic data: graph-sequence databases and LM token streams."""
