"""One-rank serving core of the port (vocab head, serve step, caches)."""
