"""The pretraining step."""
