"""Megatron-format pretraining data: indexed corpora, their index builders,
the GPT dataset and its samplers (torch port; numpy level)."""
