"""Checkpoints of (compressed) model params."""
