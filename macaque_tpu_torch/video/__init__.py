"""video of the PyTorch port."""
