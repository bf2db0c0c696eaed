"""Generation: schedules and the ROAR / MaskGIT sampler."""
