"""Discrete video tokenizers."""
