"""Utilities of the torch port: the FLOP laws and the card's peak (flops_utils)."""
