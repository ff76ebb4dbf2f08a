"""Jamba-1.5-Large-398B [hybrid] — 72L d8192 64H (GQA kv=8) d_ff=24576
vocab=65536; Mamba:attention 7:1 interleave (superblock m,m,m,a,m,m,m,m x9),
MoE 16 routed top-2 on every other layer.  Mamba layers give O(1) state ->
runs long_500k (9 attention layers keep full 512k KV: 38 MB/device @512).
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab=65536, rope_theta=0.0,  # jamba: no RoPE on attn layers
    superblock=("m", "m", "m", "a", "m", "m", "m", "m"),
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_expert=24576,
                  every_k=2, first_k_dense=0),
    d_state=16, ssm_expand=2, long_context_ok=True,
    source="arXiv:2403.19887",
)

SMOKE = ArchConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512, rope_theta=0.0,
    superblock=("m", "a"),
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_expert=128,
                  every_k=2, first_k_dense=0),
    d_state=8, ssm_expand=2, long_context_ok=True,
)
