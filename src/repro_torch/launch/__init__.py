"""launch of the PyTorch port (see repro_torch/__init__.py): the CLIs."""
