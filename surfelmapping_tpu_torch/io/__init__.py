"""Frame sources (numpy only)."""
