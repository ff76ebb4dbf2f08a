"""DeepSeekMoE-16B [moe] — 28L d2048 16H (kv=16) vocab=102400, fine-grained
MoE: 64 routed top-6 + 2 shared experts (d_expert=1408), first layer dense
(d_ff=10944).  [arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=10944, vocab=102400, rope_theta=1e4,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                  d_shared=2816, every_k=1, first_k_dense=1),
    source="arXiv:2401.06066",
)

SMOKE = ArchConfig(
    name="deepseek-moe-16b-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=256, vocab=512,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_expert=32,
                  d_shared=64, every_k=1, first_k_dense=1),
)
