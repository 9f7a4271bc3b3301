"""Train state, train step and step scheduling (torch port)."""
