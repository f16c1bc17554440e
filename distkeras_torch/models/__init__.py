"""Model architectures of the PyTorch port."""
