"""Plain PyTorch core of the port: packing, scans, conv, selective scan."""
