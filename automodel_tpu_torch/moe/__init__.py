"""Mixture-of-experts layers, port of ``automodel_tpu/moe``."""
