"""Training layer of the PyTorch port: the GAN step and ADA."""
