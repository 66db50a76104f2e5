"""Per-stage latency timing of an analysis."""
