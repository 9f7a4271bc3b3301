"""Checkpoint integrity and retried I/O (torch port of ``automodel_tpu/resilience``)."""
