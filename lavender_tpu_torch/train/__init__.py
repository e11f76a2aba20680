"""Optimizer and train step of the PyTorch port (port of lavender_tpu/train)."""
