"""Optimizers, checkpoints and the train loop, over dicts of tensors."""
