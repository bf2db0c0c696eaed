"""Training infrastructure: schedules, optimizer, config parsing, logging."""
