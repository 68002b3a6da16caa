"""Measurement scripts of the port (each needs a CUDA device to time)."""
