"""The port's resilience primitives (the part the live session uses)."""
