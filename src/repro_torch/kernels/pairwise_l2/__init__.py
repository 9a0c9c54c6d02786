"""Tiled pairwise squared-L2 distances (the cell-tiled dense backend's kernel)."""
