"""Continuous-batching serving over a paged KV pool (torch port)."""

from automodel_tpu_torch.serving.engine import ServeConfig, ServingEngine

__all__ = ["ServeConfig", "ServingEngine"]
