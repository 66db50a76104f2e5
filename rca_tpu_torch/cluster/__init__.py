"""Cluster data access: the world model, the mock client, snapshot capture
and the synthetic cascade generators."""
