"""Cluster data access: the one client protocol (``protocol.py``) and its
two backends, the mock client over a world model and the live-cluster
client (``k8s_client.py``, with its watch pumps, trace backend and live
columnar feed); snapshot capture, dict or columnar; the synthetic cascade
generators."""
