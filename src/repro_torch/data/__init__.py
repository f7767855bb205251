"""Data of the port: the synthetic corpus and the packing loaders (numpy)."""
