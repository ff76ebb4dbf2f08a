"""Llama-4-Scout-17B-16E [moe] — 48L d5120 40H (GQA kv=8) vocab=202048,
MoE 16 routed top-1 + 1 shared expert (d_expert=8192), every layer.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=202048, rope_theta=5e5,
    moe=MoEConfig(n_experts=16, top_k=1, n_shared=1, d_expert=8192,
                  d_shared=8192, every_k=1, first_k_dense=0),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE = ArchConfig(
    name="llama4-scout-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512,
    moe=MoEConfig(n_experts=4, top_k=1, n_shared=1, d_expert=64,
                  d_shared=64, every_k=1, first_k_dense=0),
)
