"""Data: the synthetic GSCD-like keyword corpus (``gscd``) and the
synthetic LM token pipeline (``lm_data``)."""
from repro_torch.data import gscd, lm_data

__all__ = ["gscd", "lm_data"]
