"""Serve-step factories (the training step comes with its own slice)."""
