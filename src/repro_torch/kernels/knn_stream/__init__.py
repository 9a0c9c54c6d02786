"""Fused streaming distance + top-k engine (the dense engine's kernel)."""
