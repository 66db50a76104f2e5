"""Synthetic cascade inputs for the engine."""
