"""Hopper kernels of the port (``csrc/``), their wrappers and plain versions."""
