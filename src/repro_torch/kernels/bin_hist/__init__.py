"""Sampled pairwise-distance histogram (ε selection)."""
