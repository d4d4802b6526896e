"""Procedural datasets (NumPy only)."""
