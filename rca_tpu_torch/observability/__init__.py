"""The port's observability: causelens provenance."""
