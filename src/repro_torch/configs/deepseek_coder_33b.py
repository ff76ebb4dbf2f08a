"""DeepSeek-Coder-33B [dense] — 62L d7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch.  [arXiv:2401.14196; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=19200, vocab=32256, rope_theta=1e5, source="arXiv:2401.14196",
)

SMOKE = ArchConfig(
    name="deepseek-coder-33b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=192, vocab=512,
)
