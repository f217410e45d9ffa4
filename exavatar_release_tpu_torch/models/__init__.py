"""Body models."""
