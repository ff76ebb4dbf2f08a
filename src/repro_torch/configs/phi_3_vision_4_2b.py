"""Phi-3-vision-4.2B [vlm] — 32L d3072 32H (kv=32, MHA) d_ff=8192
vocab=32064; CLIP frontend is a stub supplying 576 patch embeddings
(ViT-L/14 @ 336px) pre-projected to d_model.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
    d_ff=8192, vocab=32064, rope_theta=1e4, n_frontend_tokens=576,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

SMOKE = ArchConfig(
    name="phi-3-vision-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=512, n_frontend_tokens=8,
)
