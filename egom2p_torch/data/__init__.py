"""Host-side data descriptions shared by the port's models and sampler."""
