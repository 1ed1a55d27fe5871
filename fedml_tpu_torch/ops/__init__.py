"""Kernels of the port. Nothing is built at import: see ``ops/_build.py``."""
