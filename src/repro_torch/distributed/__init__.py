"""Checkpoints and gradient compression."""
