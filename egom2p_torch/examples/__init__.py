"""The cam / gaze tokenizer round-trip examples (the repo root's example_data/ scripts
without JAX)."""
