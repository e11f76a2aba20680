"""Task heads and losses of the PyTorch port (port of lavender_tpu/tasks)."""
