"""Yi-9B [dense] — 48L d4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-arch GQA.  [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=11008, vocab=64000, rope_theta=5e6, source="arXiv:2403.04652",
)

SMOKE = ArchConfig(
    name="yi-9b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512,
)
