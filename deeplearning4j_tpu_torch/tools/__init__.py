"""Measurement scripts for the port's kernels, run on the card."""
