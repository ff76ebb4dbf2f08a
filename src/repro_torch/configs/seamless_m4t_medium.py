"""SeamlessM4T-medium [audio enc-dec] — 12L enc + 12L dec, d1024 16H (kv=16,
head_dim 64) d_ff=4096 vocab=256206 (padded 256224 for 16-way sharding).
Modality frontend is a stub: input_specs supplies frame embeddings.
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_head=64, d_ff=4096, vocab=256206, rope_theta=1e4, frontend_dim=1024,
    source="arXiv:2308.11596",
)

SMOKE = ArchConfig(
    name="seamless-m4t-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, vocab=512, frontend_dim=64,
)
