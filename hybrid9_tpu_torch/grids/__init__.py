"""Host-side grids of the PyTorch port (numpy only)."""
