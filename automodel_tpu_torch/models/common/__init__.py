"""Shared model config."""
