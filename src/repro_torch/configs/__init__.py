"""Protection configuration."""
