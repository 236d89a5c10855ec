"""Synthetic graph-sequence databases."""
