"""Exact per-query top-k (the brute certification lane's kernel)."""
