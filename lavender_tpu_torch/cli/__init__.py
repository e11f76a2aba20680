"""The command-line entry points of the PyTorch port (port of
lavender_tpu/cli)."""
