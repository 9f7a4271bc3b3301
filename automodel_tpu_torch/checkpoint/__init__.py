"""Checkpoints and HF weights in and out (torch port of ``automodel_tpu/checkpoint``)."""
