"""Retrieval helpers of the port (metrics)."""
