"""Updaters (optimizers) of the port."""
