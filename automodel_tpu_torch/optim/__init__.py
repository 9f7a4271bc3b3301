"""Optimizers and LR schedules (torch port)."""
