"""Data substrate of the port: the deterministic LM token pipeline and the
paper's synthetic point clouds."""
from repro_torch.data import pointclouds
from repro_torch.data.pipeline import PipelineState, TokenPipeline

__all__ = ["PipelineState", "TokenPipeline", "pointclouds"]
