"""Core numerics of the port (formats and round-to-format)."""
