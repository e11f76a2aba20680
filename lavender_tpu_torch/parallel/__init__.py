"""The data-parallel process layer of the PyTorch port (port of
lavender_tpu/parallel)."""
