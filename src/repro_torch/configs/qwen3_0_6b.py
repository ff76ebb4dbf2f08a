"""Qwen3-0.6B [dense] — 28L d1024 16H (GQA kv=8, head_dim 128) d_ff=3072
vocab=151936, qk_norm, tied embeddings.  [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=3072, vocab=151936, qk_norm=True, rope_theta=1e6,
    tie_embeddings=True, source="hf:Qwen/Qwen3-0.6B",
)

SMOKE = ArchConfig(
    name="qwen3-0.6b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512, qk_norm=True, tie_embeddings=True,
)
