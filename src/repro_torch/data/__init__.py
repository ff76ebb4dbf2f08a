"""Data: the synthetic GSCD-like keyword corpus (``gscd``)."""
from repro_torch.data import gscd

__all__ = ["gscd"]
