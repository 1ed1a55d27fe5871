"""Measurement tools for the port; each runs on a CUDA card."""
