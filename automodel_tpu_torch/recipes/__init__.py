"""Training recipes (torch port)."""
