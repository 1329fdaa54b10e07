"""Training statistics of the PyTorch port."""
