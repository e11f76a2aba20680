"""Logging, caption metrics, profiling and misc helpers of the PyTorch
port (port of lavender_tpu/utils)."""
