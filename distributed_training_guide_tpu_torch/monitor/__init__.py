"""Cluster monitoring: ``top_cluster`` (nvidia-smi per host, stall
alerts)."""
