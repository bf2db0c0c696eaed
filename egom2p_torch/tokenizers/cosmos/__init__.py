"""Cosmos DV causal video tokenizer (encode half)."""
