"""Pretraining entry points (counterpart of the root pretrain/ CLIs)."""
