"""Command-line entry point of the torch port (``cli/app.py``)."""
