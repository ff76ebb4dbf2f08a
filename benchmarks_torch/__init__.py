"""Benchmarks of the PyTorch port (``python -m benchmarks_torch.run``)."""
