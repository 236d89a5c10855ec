"""Roofline of a dry-run cell (``analysis``)."""
