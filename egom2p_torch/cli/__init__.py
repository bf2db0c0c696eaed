"""Shared entry-point helpers (model and tokenizer loading)."""
