"""Physics ops of the PyTorch port (2D structured grids)."""
