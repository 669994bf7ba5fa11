"""Training config, loop, optimizer, metrics and logging."""
