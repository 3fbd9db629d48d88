"""Model and protection configuration."""
