"""Synthetic datasets of the port (numpy, no downloads)."""
