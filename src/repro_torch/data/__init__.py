"""Synthetic data: graph-sequence databases, LM token streams, graphs
and molecules with a neighbor sampler, and recsys sessions."""
