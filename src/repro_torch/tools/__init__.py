"""Measurement scripts for the CUDA kernels, run by hand on the card."""
