"""The data plane of the PyTorch port (port of lavender_tpu/data/)."""
