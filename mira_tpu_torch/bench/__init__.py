"""Measurements of the kernels' building blocks on the card (not used by the
port's code paths)."""
