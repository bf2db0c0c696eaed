"""Attention, kernels and numeric building blocks of the port."""
