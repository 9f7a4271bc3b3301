"""Metric logging (torch port)."""
