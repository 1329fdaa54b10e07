"""Data parallelism and training statistics of the PyTorch port."""
