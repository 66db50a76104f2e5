"""Topology construction (snapshot → typed COO arrays) and the deterministic
graph analyses: the port's copy of ``rca_tpu.graph``."""
