"""Camera-trajectory and gaze visualisers (the repo root's vis_3d/ without JAX)."""
