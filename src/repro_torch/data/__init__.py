"""Data substrate of the port: the paper's synthetic point clouds."""
from repro_torch.data import pointclouds

__all__ = ["pointclouds"]
