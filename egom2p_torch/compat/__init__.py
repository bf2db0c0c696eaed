"""Converters from the JAX package's parameters to the port's state dicts."""
