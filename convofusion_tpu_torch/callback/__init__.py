"""Training callbacks."""
