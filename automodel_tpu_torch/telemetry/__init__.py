"""Telemetry of the torch port: device memory (memory) and the shared percentile (report)."""
